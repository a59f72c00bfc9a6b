"""The comparison fails what it must: the control (the reference one
precision down in the program's place) and a run with the timed path
broken underneath, once for each fault a cell can have on one chip: a
step that returns its state unchanged, half of the batch left out (the
mean over the rest: its cutouts, or its share of the loss), a frame
altered where it is rendered.  On the CPU
at a tiny size; the control again on the card at the cells' own size."""
from __future__ import annotations

import pytest
import torch

from benchmark.harness import check, core
from benchmark.tests.tiny import run_tiny, tiny_cell, tiny_program

CELLS = ("clip_fft.b32.720p", "clip_vqgan.f16.480p", "illustrip.b32.rgb.720p")


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    from benchmark.control import readings
    cell = tiny_cell(workload)
    with tiny_program():
        r = readings(cell, 7, True, "cpu")
    prog = check.judge(r["program"], cell.limits)
    assert all(v["ok"] for v in prog.values()), prog
    ctrl = check.judge(r["control"], cell.limits)
    assert not all(v["ok"] for v in ctrl.values()), ctrl
    for fault in ("half_cuts", "half_loss"):
        half = check.judge(r[fault], cell.limits)
        assert not all(v["ok"] for v in half.values()), (fault, half)


def _unchanged(monkeypatch):
    from aphantasia_torch.ops import optim

    def step(self, params, grads, state):
        state.count.add_(1)
    monkeypatch.setattr(optim.Adam, "step", step)


def _half_batch(monkeypatch):
    from aphantasia_torch.ops import sampler
    cut = sampler.CutoutSampler.cut

    def half(self, img, boxes, compute_dtype=None):
        cuts = cut(self, img, boxes, compute_dtype)
        n = cuts.shape[0] // 2
        return torch.cat([cuts[:n], cuts[:cuts.shape[0] - n]])
    monkeypatch.setattr(sampler.CutoutSampler, "cut", half)


def _half_loss(monkeypatch):
    """Every cutout embedded, the similarity's means over half of them."""
    from aphantasia_torch import step
    sim = step.sim_func

    def half(v1, v2, type=None):
        return sim(v1, v2[:max(1, v2.shape[0] // 2)], type)
    monkeypatch.setattr(step, "sim_func", half)


def _frame_altered(monkeypatch):
    from aphantasia_torch import step
    build = step.build_render

    def altered(parameterizer):
        render = build(parameterizer)
        return lambda params, contrast=1.0: 255 - render(params, contrast)
    monkeypatch.setattr(step, "build_render", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _half_loss,
                                   _frame_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, compared, _ = run_tiny(tiny_cell(workload))
    assert result["correct"] is False, compared


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    core.run_environment()


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS + ("clip_fft.b32.4k",))
def test_control_is_not_correct_on_the_card(card, workload):
    from benchmark.control import readings
    cell = core.Cell(workload)
    r = readings(cell, 2147483000 + len(workload), True)
    assert all(v["ok"] for v in check.judge(r["program"],
                                            cell.limits).values())
    assert not all(v["ok"] for v in check.judge(r["control"],
                                                cell.limits).values())
