#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`aphantasia_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as a check of the port
    python3 chip_smoke.py --phases kernels # only build + hold the kernels

Phases, in order; any failure exits non-zero and no phase carries on past one:

  kernels  build every CUDA kernel from `aphantasia_torch/csrc/` (one nvcc per
           source, all started together), then hold each kernel against its
           plain PyTorch version on the card, forward and gradient, at the
           shapes of the main path, and time kernel, plain version and the
           PyTorch library call that computes the same function.
  main     `aphantasia_torch.cli.clip_fft.run` at full width (ViT-B/32 with
           random weights, 1280x720, 200 samples, `--pallas`), then the same
           run without `--pallas` (the default einsum cutout).  The launch
           counts are set to 0 just before each run and read just after.
           Steps/s is the median of the steps after the first.
  parity   the train step on the card against the same step on the CPU,
           from the same weights and the same random draws, at a small size.
  profile  (only when asked for) torch.profiler over steady steps of both
           cutout paths: device time by kernel and the device busy share.

The last two lines of standard output are one JSON object describing every
kernel and `{"ok": true, "device": {...}}`.  Without a CUDA device, or
without the `aphantasia_torch` package beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and op/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}

# the four kernels of the slice: the C wrapper name in kernels.LAUNCHES ->
# (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "attn_fwd": ("aphantasia_torch/csrc/attention.cu",
                 "aphantasia_tpu/ops/pallas_attn.py:412"),
    "attn_bwd": ("aphantasia_torch/csrc/attention.cu",
                 "aphantasia_tpu/ops/pallas_attn.py:442"),
    "cutout_fwd": ("aphantasia_torch/csrc/cutout.cu",
                   "aphantasia_tpu/ops/pallas_cutout.py:109"),
    "cutout_bwd": ("aphantasia_torch/csrc/cutout.cu",
                   "aphantasia_tpu/ops/pallas_cutout.py:139"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls, from CUDA
    events around the whole run (after `warmup` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, ops: float, kind: str):
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    d = (a.float() - b.float()).abs().max().item()
    return d, b.float().abs().max().item()


# ---------------------------------------------------------------- kernels

def check_attention(rows, t, d, heads, dtype, causal=False, valid_t=None,
                    seed=0, timed=False):
    """Kernel against `attention_plain`: forward and d(qkv).  Returns a dict
    with errors (and times when `timed`)."""
    import torch
    from aphantasia_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((rows, 3 * d), generator=g, device="cuda").to(dtype)
    dout = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
    out, lse = A.attention_fwd_kernel(qkv, heads, t, causal, valid_t)
    dqkv = A.attention_bwd_kernel(qkv, dout, out, lse, heads, t, causal,
                                  valid_t)
    q_req = qkv.clone().requires_grad_(True)
    ref = A.attention_plain(q_req, heads, t, causal, valid_t)
    (dref,) = torch.autograd.grad(ref, q_req, dout)
    torch.cuda.synchronize()
    vt = valid_t or t
    rowmask = (torch.arange(rows, device="cuda") % t) < vt
    fe, fs = max_err(out[rowmask], ref.detach()[rowmask])
    ge, gs = max_err(dqkv, dref)
    # bf16: both sides compute in float32 from the same bf16 inputs and
    # round once at the end, so they differ by a rounding step of the
    # output (2^-8 relative) plus float32 sum-order noise
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-5
    res = {"fwd_err": fe, "fwd_scale": fs, "grad_err": ge, "grad_scale": gs,
           "tol_rel": tol}
    check(math.isfinite(fe) and fe <= tol * max(fs, 1.0),
          f"attention fwd {dtype} t={t} causal={causal} valid_t={valid_t}: "
          f"max |err| {fe:.3g} > {tol:.3g} * {max(fs, 1.0):.3g}")
    check(math.isfinite(ge) and ge <= tol * 5 * max(gs, 1.0),
          f"attention grad {dtype} t={t}: max |err| {ge:.3g} > "
          f"{tol * 5:.3g} * {max(gs, 1.0):.3g}")
    if not timed:
        return res
    import torch.nn.functional as F
    b = rows // t
    hd = d // heads
    res["ms_fwd"] = cuda_ms(lambda: A.attention_fwd_kernel(
        qkv, heads, t, causal, valid_t))
    res["ms_bwd"] = cuda_ms(lambda: A.attention_bwd_kernel(
        qkv, dout, out, lse, heads, t, causal, valid_t))
    res["plain_fwd"] = cuda_ms(lambda: A.attention_plain(
        qkv, heads, t, causal, valid_t))
    plain_fb = cuda_ms(lambda: torch.autograd.grad(
        A.attention_plain(q_req, heads, t, causal, valid_t), q_req, dout))
    res["plain_bwd"] = max(plain_fb - res["plain_fwd"], 0.0)

    def sdpa(x):
        q, k, v = x.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    res["lib_fwd"] = cuda_ms(lambda: sdpa(qkv))
    do4 = dout.reshape(b, t, heads, hd).permute(0, 2, 1, 3)
    lib_fb = cuda_ms(lambda: torch.autograd.grad(sdpa(q_req), q_req, do4))
    res["lib_bwd"] = max(lib_fb - res["lib_fwd"], 0.0)
    es = qkv.element_size()
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    pairs = b * heads * (t * (t + 1) // 2 if causal else t * vt)
    res["bound_fwd"] = bound(rows * 3 * d * es + rows * d * es
                             + rows * heads * 4, 4 * pairs * hd, kind)
    res["bound_bwd"] = bound(rows * 3 * d * es + 2 * rows * d * es
                             + rows * heads * 4 + rows * 3 * d * es,
                             10 * pairs * hd, kind)
    return res


def check_cutout(seed=0):
    """Cutout kernel against `cutout_plain` at 1280x720, S=200, M=224."""
    import torch
    from aphantasia_torch.ops import cutout as C
    from aphantasia_torch.ops.sampler import CutoutSampler, _contract
    h, w, s, m = 720, 1280, 200, 224
    g = torch.Generator(device="cuda").manual_seed(seed)
    sampler = CutoutSampler((h, w), s, m, "uniform", 0.4)
    boxes = sampler.sample_boxes(g)
    taps = sampler.tap_indices(boxes)
    img = torch.rand((3, h, w), generator=g, device="cuda")
    gout = torch.randn((s, 3, m, m), generator=g, device="cuda")
    out = C.cutout_fwd_kernel(img, *taps)
    dimg = C.cutout_bwd_kernel(gout, *taps, tuple(img.shape))
    i_req = img.clone().requires_grad_(True)
    ref = C.cutout_plain(i_req, *taps)
    (dref,) = torch.autograd.grad(ref, i_req, gout)
    torch.cuda.synchronize()
    fe, fs = max_err(out, ref.detach())
    ge, gs = max_err(dimg, dref)
    # float32 throughout; the backward's atomics add in a run-dependent order
    tol_f, tol_g = 1e-5, 1e-4
    check(fe <= tol_f * max(fs, 1.0), f"cutout fwd: max |err| {fe:.3g}")
    check(ge <= tol_g * max(gs, 1.0), f"cutout grad: max |err| {ge:.3g}")
    res = {"fwd_err": fe, "fwd_scale": fs, "grad_err": ge, "grad_scale": gs,
           "tol_fwd": tol_f, "tol_grad": tol_g}
    del ref, dref
    res["ms_fwd"] = cuda_ms(lambda: C.cutout_fwd_kernel(img, *taps))
    res["ms_bwd"] = cuda_ms(lambda: C.cutout_bwd_kernel(
        gout, *taps, tuple(img.shape)))
    res["plain_fwd"] = cuda_ms(lambda: C.cutout_plain(img, *taps), iters=5)
    plain_fb = cuda_ms(lambda: torch.autograd.grad(
        C.cutout_plain(i_req, *taps), i_req, gout), iters=5)
    res["plain_bwd"] = max(plain_fb - res["plain_fwd"], 0.0)
    torch.cuda.empty_cache()
    # yardstick: the port's own dense einsum contraction (the default
    # non --pallas path, cuBLAS batched matmuls) on the same boxes, float32
    wy, wx = sampler.weight_matrices(boxes, dtype=torch.float32)
    res["lib_fwd"] = cuda_ms(lambda: _contract(img, wy, wx, torch.float32),
                             iters=5)
    lib_fb = cuda_ms(lambda: torch.autograd.grad(
        _contract(i_req, wy, wx, torch.float32), i_req, gout), iters=5)
    res["lib_bwd"] = max(lib_fb - res["lib_fwd"], 0.0)
    tap_bytes = 4 * s * m * 4 * 4
    res["bound_fwd"] = bound(3 * h * w * 4 + tap_bytes + s * 3 * m * m * 4,
                             s * 3 * m * m * 40, "f32")
    res["bound_bwd"] = bound(s * 3 * m * m * 4 + tap_bytes + 3 * h * w * 4,
                             s * 3 * m * m * 40, "f32")
    return res


def phase_kernels(report):
    import torch
    from aphantasia_torch import kernels
    t0 = time.time()
    kernels.build_all()
    print(f"[kernels] built {', '.join(kernels.SOURCES)} in "
          f"{time.time() - t0:.1f} s")
    for name, log in kernels.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[kernels] {name}: {line.strip()}")
    cases = [
        ("vision flat bf16", dict(rows=10000, t=50, d=768, heads=12,
                                  dtype=torch.bfloat16, timed=True)),
        ("vision flat f32", dict(rows=10000, t=50, d=768, heads=12,
                                 dtype=torch.float32)),
        ("text causal f32", dict(rows=2 * 77, t=77, d=512, heads=8,
                                 dtype=torch.float32, causal=True)),
        ("padded valid_t bf16", dict(rows=16 * 64, t=64, d=768, heads=12,
                                     dtype=torch.bfloat16, valid_t=50)),
        ("vit-b/16 t=197 f32", dict(rows=4 * 197, t=197, d=768, heads=12,
                                    dtype=torch.float32)),
        ("vit-l/14 t=257 f32", dict(rows=4 * 257, t=257, d=1024, heads=16,
                                    dtype=torch.float32)),
        ("text causal 1x77x1536 f32", dict(rows=77, t=77, d=512, heads=8,
                                           dtype=torch.float32, causal=True,
                                           timed=True)),
        ("vit-b/16 47x197x2304 bf16", dict(rows=47 * 197, t=197, d=768,
                                           heads=12, dtype=torch.bfloat16,
                                           timed=True)),
    ]
    for label, kw in cases:
        r = check_attention(**kw)
        print(f"[kernels] attention {label}: fwd max|err| {r['fwd_err']:.3g} "
              f"(|ref| {r['fwd_scale']:.3g}), grad max|err| "
              f"{r['grad_err']:.3g} (|ref| {r['grad_scale']:.3g}), "
              f"tol {r['tol_rel']:.3g} rel")
        if not kw.get("timed"):
            continue
        for k in ("fwd", "bwd"):
            print(f"[kernels] attention {k} {label}: kernel "
                  f"{r['ms_' + k]:.4f} ms, plain {r['plain_' + k]:.4f} ms, "
                  f"sdpa {r['lib_' + k]:.4f} ms, bound "
                  f"{r['bound_' + k][0]:.4f} ms ({r['bound_' + k][1]})")
        if label == "vision flat bf16":
            att = r
    cut = check_cutout()
    print(f"[kernels] cutout fwd max|err| {cut['fwd_err']:.3g} (|ref| "
          f"{cut['fwd_scale']:.3g}), grad max|err| {cut['grad_err']:.3g} "
          f"(|ref| {cut['grad_scale']:.3g})")
    for k in ("fwd", "bwd"):
        print(f"[kernels] cutout {k} S=200 M=224 720x1280: kernel "
              f"{cut['ms_' + k]:.4f} ms, plain {cut['plain_' + k]:.4f} ms, "
              f"einsum {cut['lib_' + k]:.4f} ms, bound "
              f"{cut['bound_' + k][0]:.4f} ms ({cut['bound_' + k][1]})")
    for name, r, k, err in (("attn_fwd", att, "fwd", att["fwd_err"]),
                            ("attn_bwd", att, "bwd", att["grad_err"]),
                            ("cutout_fwd", cut, "fwd", cut["fwd_err"]),
                            ("cutout_bwd", cut, "bwd", cut["grad_err"])):
        src, rep = KERNELS[name]
        report[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": err, "ms": r["ms_" + k],
            "plain_ms": r["plain_" + k], "bound_ms": r["bound_" + k][0],
            "bound_by": r["bound_" + k][1], "library_ms": r["lib_" + k]}


# ---------------------------------------------------------------- main path

def _run_cli(argv, on_step=None):
    from aphantasia_torch.cli import clip_fft
    return clip_fft.run(clip_fft.get_args(argv), on_step)


def phase_main(report, steps: int):
    import torch
    from aphantasia_torch import kernels
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    out = os.path.join(OUT_DIR, "pallas")
    argv = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
            "--samples", "200", "--steps", str(steps), "--pallas",
            "--out_dir", out, "--save_pt", "-nv", "--seed", "1"]
    kernels.reset_launches()
    res = _run_cli(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    name = torch.cuda.get_device_name(0)
    print(f"[main] --pallas run: launches {launches}")
    losses = res.losses
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"main path losses not finite: {losses}")
    for k in KERNELS:
        check(launches.get(k, 0) > 0, f"main path never launched {k}")
        if k in report:
            report[k]["launches"] = launches[k]
    # every step: 12 vision layers forward and backward, one cutout each
    # way; before the loop: 12 text layers for the one prompt
    expect = {"attn_fwd": 12 * steps + 12, "attn_bwd": 12 * steps,
              "cutout_fwd": steps, "cutout_bwd": steps}
    check(launches == expect, f"launches {launches} != expected {expect}")
    run_dir = os.path.join(out, res.out_name)
    frames = sorted(f for f in os.listdir(run_dir) if f.endswith(".jpg"))
    check(len(frames) == steps, f"expected {steps} frames, got {frames}")
    check(os.path.isfile(os.path.join(run_dir, "config.txt")),
          "config.txt missing")
    check(res.video is not None and res.video.endswith(".mp4")
          and os.path.getsize(res.video) > 0, f"no mp4 written: {res.video}")
    check(os.path.isfile(os.path.join(out, res.out_name + ".pt")),
          ".pt snapshot missing")
    check(tuple(res.params.shape) == (1, 3, 720, 641, 2)
          and bool(torch.isfinite(res.params).all()), "bad final params")
    steady = sorted(res.step_seconds[1:] or res.step_seconds)
    print(f"[main] {steps} steps at 1280x720, {res.samples} cutouts, ViT-B/32 "
          f"bf16, --pallas: first step {res.step_seconds[0]:.3f} s, steady "
          f"{1.0 / steady[len(steady) // 2]:.3f} steps/s on {name}; "
          f"losses {[round(x, 5) for x in losses]}")

    out2 = os.path.join(OUT_DIR, "einsum")
    argv2 = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
             "--samples", "200", "--steps", str(steps), "--out_dir", out2,
             "-nv", "--seed", "1"]
    kernels.reset_launches()
    res2 = _run_cli(argv2)
    torch.cuda.synchronize()
    launches2 = dict(kernels.LAUNCHES)
    print(f"[main] default (einsum cutout) run: launches {launches2}")
    check(all(math.isfinite(x) for x in res2.losses),
          f"einsum path losses not finite: {res2.losses}")
    check(launches2.get("attn_fwd", 0) > 0 and launches2.get("attn_bwd", 0) > 0,
          "default path never launched the attention kernels")
    check(launches2.get("cutout_fwd", 0) == 0,
          "default path launched the cutout kernel")
    steady2 = sorted(res2.step_seconds[1:] or res2.step_seconds)
    print(f"[main] default path: {steps} steps, first step "
          f"{res2.step_seconds[0]:.3f} s, steady "
          f"{1.0 / steady2[len(steady2) // 2]:.3f} steps/s on {name}; "
          f"losses {[round(x, 5) for x in res2.losses]}")


# ---------------------------------------------------------------- profile

def _device_us(evt) -> float:
    for key in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, key, None)
        if v is not None:
            return float(v)
    return 0.0


def phase_profile(steps: int = 6, active: int = 3):
    """Where a steady step's device time goes, for both cutout paths:
    torch.profiler over `active` steps after `steps - active` warm ones;
    the kernels by self device time per step, and the device busy share
    (kernel time over the host wall time of those steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    name = torch.cuda.get_device_name(0)
    for label, extra in (("--pallas", ["--pallas"]), ("default", [])):
        argv = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
                "--samples", "200", "--steps", str(steps), "-nv", "--seed",
                "1", "--out_dir", os.path.join(OUT_DIR, "profile")] + extra
        marks = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=steps - active,
                                       active=active, repeat=1)) as prof:
            def on_step(i):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                prof.step()
            _run_cli(argv, on_step)
        wall = marks[-1] - marks[-1 - active]
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")]
        total = sum(_device_us(e) for e in evts) / 1e3 / active
        check(total > 0, "the profiler saw no device time")
        print(f"[profile] {label}: {wall / active * 1e3:.2f} ms/step host "
              f"wall, {total:.2f} ms/step device kernels, busy share "
              f"{total / (wall / active * 1e3):.3f} on {name}")
        for e in sorted(evts, key=_device_us, reverse=True)[:15]:
            ms = _device_us(e) / 1e3 / active
            print(f"[profile] {label}:   {ms:8.3f} ms/step "
                  f"{ms / total:6.1%}  x{e.count // active:<4d} "
                  f"{e.key[:90]}")


# ---------------------------------------------------------------- parity

PARITY_LR = 0.05


def _parity_setup(device, use_pallas, transform):
    """A small float32 step (tiny ViT, 96x64 frame, 6 cutouts at 64) with
    the same weights, start and prompts on either device."""
    import torch
    from aphantasia_torch.models.clip.model import CLIPConfig, clip_init
    from aphantasia_torch.ops.optim import build_optimizer
    from aphantasia_torch.ops.sampler import CutoutSampler
    from aphantasia_torch.params.fft import FFTParameterizer
    from aphantasia_torch.step import (StepSettings, build_draw_fn,
                                       build_loss_fn, build_train_step)
    cfg = CLIPConfig("tiny", 64, 64, 2, 128, 16, transformer_width=64,
                     transformer_heads=2, transformer_layers=1)
    g = torch.Generator().manual_seed(0)
    clip = clip_init(g, cfg)
    clip = {"visual": _tree_to(clip["visual"], device)}
    par = FFTParameterizer((64, 96), 1.5, 1.8)
    p0 = par.init(g, sd=0.07).to(device)
    prompts = ((torch.randn((2, 64), generator=g).to(device),
                torch.tensor([1.0, 0.5], device=device), -1.0),)
    sampler = CutoutSampler((64, 96), 6, 64, "uniform", 0.4,
                            use_pallas=use_pallas)
    settings = StepSettings(sim="mix", transform=transform, noise=0.1,
                            sharp=0.2, expand=0.5, clip_dtype=torch.float32)
    opt = build_optimizer("adam_custom", PARITY_LR, 2)
    return dict(clip=clip, p0=p0, prompts=prompts, opt=opt,
                draw=build_draw_fn(sampler, settings, tuple(p0.shape)),
                loss=build_loss_fn(par, sampler, cfg, settings),
                step=build_train_step(par, sampler, cfg, settings, opt))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_parity():
    """The train step on the card (kernels) against the same step on the
    CPU (plain versions), float32, same weights and draws.  With the `none`
    transform two free-running steps: losses within 1e-4, params within
    2e-3 of the learning rate in the mean and 5e-2 at the worst element
    (Adam with b1 = 0 turns float32 noise in a near-zero gradient element
    into a full-size update of that element).  The `fast` transform warps
    in bf16 on both devices, so it is held at one step: loss within 2e-3
    relative, gradient within 2e-2 relative L2 error."""
    import torch
    from aphantasia_torch.step import to_device
    for use_pallas in (True, False):
        runs = {}
        for dev in ("cpu", "cuda"):
            c = _parity_setup(dev, use_pallas, "none")
            g = torch.Generator().manual_seed(1)
            p, st = c["p0"].clone(), c["opt"].init(c["p0"])
            prev = torch.zeros((6, 64), device=dev)
            losses = []
            for i in range(2):
                p, st, prev, loss = c["step"](p, st, prev, c["clip"],
                                              c["prompts"],
                                              to_device(c["draw"](g), dev), i)
                losses.append(loss.item())
            runs[dev] = (losses, p.cpu())
        le = max(abs(a - b) for a, b in zip(runs["cpu"][0], runs["cuda"][0]))
        err = (runs["cpu"][1] - runs["cuda"][1]).abs()
        print(f"[parity] none, pallas={use_pallas}: losses cpu "
              f"{runs['cpu'][0]} cuda {runs['cuda'][0]}; params |err| mean "
              f"{err.mean().item():.3g} max {err.max().item():.3g} "
              f"(lr {PARITY_LR})")
        check(le <= 1e-4, f"card vs CPU loss differs by {le}")
        check(err.mean().item() <= 2e-3 * PARITY_LR
              and err.max().item() <= 5e-2 * PARITY_LR,
              "card vs CPU params differ")
        grads = {}
        for dev in ("cpu", "cuda"):
            c = _parity_setup(dev, use_pallas, "fast")
            x = c["p0"].clone().requires_grad_(True)
            d = to_device(c["draw"](torch.Generator().manual_seed(2)), dev)
            loss, _ = c["loss"](x, c["clip"], c["prompts"],
                                torch.zeros((6, 64), device=dev), d, 0)
            (gr,) = torch.autograd.grad(loss, x)
            grads[dev] = (loss.item(), gr.cpu())
        lr_ = abs(grads["cpu"][0] - grads["cuda"][0]) / abs(grads["cpu"][0])
        ge = ((grads["cpu"][1] - grads["cuda"][1]).norm()
              / grads["cpu"][1].norm()).item()
        print(f"[parity] fast, pallas={use_pallas}: loss cpu "
              f"{grads['cpu'][0]:.6f} cuda {grads['cuda'][0]:.6f}, grad "
              f"relative L2 error {ge:.3g}")
        check(lr_ <= 2e-3 and ge <= 2e-2, "card vs CPU fast-step differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,main,parity")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        import aphantasia_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the aphantasia_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}
    t0 = time.time()
    try:
        for ph in phases:
            t = time.time()
            {"kernels": lambda: phase_kernels(report),
             "main": lambda: phase_main(report, args.steps),
             "parity": phase_parity,
             "profile": phase_profile}[ph]()
            print(f"[{ph}] done in {time.time() - t:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[total] {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": [report[k] for k in KERNELS if k in report]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
