"""The port's `verify_weights` (aphantasia_torch/verify_weights.py) on the
CPU, as tests/test_verify_weights.py holds the JAX package's: the table
with no checkpoints (every row MISSING, exit 0), a synthetic aesthetic
head verified against torch, a broken checkpoint failing the run, and a
taming VQGAN state dict converted; on each directory the port's rows
(component and status) equal the JAX package's."""
import pytest
import torch

from aphantasia_tpu import verify_weights as jvw
from aphantasia_tpu.models import vqgan as jv
from aphantasia_torch import verify_weights as tvw
from aphantasia_torch.models import vqgan as tv

from test_torch_vqgan import CFGS, _taming_sd

ENV = ("APHANTASIA_CLIP_PT", "APHANTASIA_AEST_PT", "APHANTASIA_LPIPS_PT",
       "APHANTASIA_DAV2_PT", "APHANTASIA_VQGAN_PT")


def _aesthetic(d):
    torch.save(torch.nn.Linear(512, 1).state_dict(),
               str(d / "sa_0_4_vit_b_32_linear.pth"))


def _bad_lpips(d):
    (d / "lpips_vgg.pt").write_bytes(b"not a checkpoint")


def _vqgan(d):
    torch.save(_taming_sd(tv.VQGANConfig(**CFGS["f16"])), str(d / "vqgan.pt"))


@pytest.mark.parametrize("make,rc,summary,rows", [
    ([], 0, "0/5 present, 0 torch-verified, 5 missing, 0 failed", {}),
    ([_aesthetic], 0, "1/5 present, 1 torch-verified, 4 missing, 0 failed",
     {"aesthetic": "verified"}),
    ([_bad_lpips], 1, "0/5 present, 0 torch-verified, 4 missing, 1 failed",
     {"lpips": "FAILED"}),
    ([_vqgan, _aesthetic], 0,
     "2/5 present, 1 torch-verified, 3 missing, 0 failed",
     {"aesthetic": "verified", "vqgan": "converted"})])
def test_table_matches_jax(tmp_path, capsys, monkeypatch, make, rc, summary,
                           rows):
    """The exit code and the summary line; each row's status, equal to the
    JAX package's on the same directory (its VQGAN config cut to the
    tiny f16-like decoder in both packages)."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    for cfgs, mod in ((tv.VQGAN_CONFIGS, tv), (jv.VQGAN_CONFIGS, jv)):
        monkeypatch.setitem(cfgs, "imagenet_f16_16384",
                            mod.VQGANConfig(**CFGS["f16"]))
    for fn in make:
        fn(tmp_path)
    assert tvw.main([str(tmp_path), "--device", "cpu"]) == rc
    out = capsys.readouterr().out
    assert summary in out
    got, failed = tvw.collect_rows(str(tmp_path))
    want, jfailed = jvw.collect_rows(str(tmp_path))
    assert failed == jfailed == bool(rc)
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want]
    status = {r[0]: r[2] for r in got}
    assert len(status) == 5
    for comp, st in status.items():
        assert st == rows.get(comp, "MISSING"), (comp, st)
    if "aesthetic" in rows:
        line = next(ln for ln in out.splitlines()
                    if ln.strip().startswith("aesthetic"))
        err = float(line.split("max |diff|")[1].split()[0])
        assert err < 1e-6


def test_env_variable_and_device(tmp_path, monkeypatch):
    """A checkpoint named by its APHANTASIA_*_PT variable is found without
    a directory; `--device cuda` without a GPU raises."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    _aesthetic(tmp_path)
    monkeypatch.setenv("APHANTASIA_AEST_PT",
                       str(tmp_path / "sa_0_4_vit_b_32_linear.pth"))
    rows, failed = tvw.collect_rows(None)
    assert not failed and dict((r[0], r[2]) for r in rows)["aesthetic"] == \
        "verified"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvw.main([])
