#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`aphantasia_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as a check of the port
    python3 chip_smoke.py --phases kernels # only build + hold the kernels

Phases, in order; any failure exits non-zero and no phase carries on past one:

  kernels  build every CUDA kernel from `aphantasia_torch/csrc/` (one nvcc per
           source, all started together), then hold each kernel against its
           plain PyTorch version on the card, forward and gradient, at the
           shapes of the main path, and time kernel, plain version and the
           PyTorch library call that computes the same function: CUDA
           events around back-to-back calls, and for the kernels (and the
           library calls of the windowed cutout and the LayerNorm) the
           device time of the same calls replayed from a CUDA graph
           (`graph_ms`, no profiler needed).  The cutout pair also at
           cppn's 47 cutouts (overscan) of a 512x512 frame and clip_vqgan's
           190 of 640x512; the default cut's contraction pair at 190
           cutouts of 224 from 1280x720 and 3840x2160, bit for bit its
           plain version, beside the dense `_contract` it replaced; the
           VQGAN decode alone (f16 at 640x480, gumbel
           f8 at 640x512): bf16 held to float32 by the JAX package's bound,
           each dtype's forward and forward + latent gradient by graph
           replay against their operation bounds.
  main     `aphantasia_torch.cli.clip_fft.run` at full width (ViT-B/32 with
           random weights, 1280x720, 200 samples, `--pallas`), then the same
           run without `--pallas` (the default cut, the contraction
           kernel pair), then with
           `--pallas` and each augmentation path of the exact perspective
           and fractional-shift kernels: `--persp mixed`, `--persp exact`,
           `-tf elastic` with APHANTASIA_PALLAS_SHIFT=1 and without it; then
           the windowed-cutout and LayerNorm kernels' paths: ViT-B/32 with
           APHANTASIA_WIN_CUTOUT=1 and APHANTASIA_PALLAS_LN=1, ViT-L/14 with
           both and ViT-L/14 without them; then the fused half blocks'
           path: ViT-B/32 with APHANTASIA_FUSED_BLOCK=1, alone and with the
           other two switches; then `--pallas` with (f) `--dualmod 4`
           (ViT-B/32 and ViT-B/16), (g) `--sync 0.4 -i` (a 1280x720 image
           written here), (h) `--aest 1 --clip_weights` (a full-width
           ViT-B/32 checkpoint in the OpenAI layout, written here and
           deleted) and (i) `--dwt`; the ViT-L/14@336px image tower (577
           tokens) at full width, one bf16 forward and backward; (j)-(m)
           `--pallas -m RN50|RN101|RN50x4|RN50x16` (cutouts of 224, 224,
           288, 384 px); (n) `illustra --pallas` over three scenes of a
           text file written here, with the crossfade at --lsteps 25;
           (o) `illustra -m RN50x64 --pallas` (one cutout of 448 px), two
           scenes; (p) `interpol` on (n)'s snapshots; (q) `illustra -m
           ViT-L/14@336px --samples 40`; (r) one eager step of that model
           at illustra's default budget (its peak memory or its
           out-of-memory error, reported); `illustrip` at 100 samples
           (95 cutouts, ViT-B/32): (s) `--gen RGB` over two scenes of 24
           frames, (t) `--gen FFT --opt_step 3 -tf fast` (the
           configuration of `bench_illustrip.py`), 24 frames, (u) (s) with
           `--pallas`, (v) (t) with `--depth 1` (DA-V2 b) and
           `--depth_dir`, 16 frames, (w) `--gen FFT --smooth --dualmod 2`
           (21 cutouts), 24 frames, each with frames/min (the first frame
           apart), device ms a frame by graph replay and busy share; (x)
           `depth` on three images of two sizes; (y) `cppn` (a 10-layer
           CPPN, 512x512, 50 cutouts, a frame and a `.npy` snapshot a
           step, the shaders), (z) `cppn --gen siren`, (aa) `cppn --pallas
           -tf --fstep 2` (47 cutouts), (ab) `clip_vqgan` (imagenet f16
           from a taming state dict written here, 640x480, 190 cutouts),
           (ac) `clip_vqgan --vqgan gumbel_f8_8192 -s 640-512 --pallas`,
           each with steps/s, device ms a step by replay and busy share.
           Each prints its
           steps/s, peak memory and wall.  The
           launch counts are set to 0 just before each run and read just
           after, and must equal the counts the path implies.  The 8-step
           runs take the CLI's chunked path (one eager frame group and its
           capture, then replays), whose launches are counted per replay.
           Steps/s is the median of the steps after the first.
  loop     the step loop (`build_train_loop_frames`) on the default,
           `--pallas` (with opt_step 2), `--pallas --persp exact`,
           `--pallas -tf elastic` with the shift kernel, (a), (b), (d),
           (f) `--dualmod 3` with opt_step 2 (three tower patterns, a graph
           each), (g) `--sync 0.4 -i`, (i) `--dwt` and (j) `-m RN50
           --pallas` paths at full width:
           the eager steps twice, then the same steps from the same draws
           replayed from CUDA graphs, held to the eager run bit for bit (or
           within the eager runs' own spread), replay-only dispatches under
           sync debug mode "error"; steps/s eager and replayed, each
           graph's device ms by replay, busy share, peak memory
           (`phase_loop`); then two `illustra` scenes, the first scene's
           graph replayed in the second after its copy-in, held to two
           eager runs with no second capture (`phase_loop_illustra`);
           then illustrip frames (RGB, FFT `--smooth`, FFT `--depth 1`)
           through `build_frame_step` and the DA-V2 graph, held to two
           eager runs of the frame step's pieces (`phase_loop_illustrip`);
           then cppn (`--fstep 2`, with its per-group params snapshots)
           and clip_vqgan (f16) through their CLIs' `setup`, the replayed
           frame loop held to two eager runs, snapshots included
           (`phase_loop_coord`).
  parity   the train step on the card against the same step on the CPU,
           from the same weights and the same random draws, at a small size,
           for the `none`, `fast` (affine, mixed and exact) and `elastic`
           (kernel shift) transforms, for `none` under the cutout and
           LayerNorm switches and under the block switch, with `--aest`
           and `--sync`, on a DWT pyramid, two `--dualmod` steps, a tiny
           ModifiedResNet step, two `illustra` scenes (the second
           replayed on the card), two illustrip frames of RGB and of
           FFT (the second replayed on the card), and one step each of a
           CPPN, a SIREN and a float32 VQGAN decoder.
  mesh     the parallel paths one card can run (ROADMAP.md A.10a): (ad)
           `clip_fft` at its default width (ViT-B/32, 1280x720, 190
           cutouts, the chunked graph path, 8 steps) with `--fleet
           0/1@127.0.0.1:PORT --mesh dcn`, a data axis of one rank in an
           NCCL group, against the same run without `--mesh` (in turns:
           dense, mesh, mesh, dense): losses, frame files and the final
           `.pt` bit for bit, the axis' gather and gradient sum launched
           inside the captured group (their counts a step in the graph),
           steps/s of the four runs; then
           that mesh's eager steps twice and replayed, bit for bit;
           (ae) `illustra` as a fleet of two processes sharing the card
           (`--fleet 0/2@...` and `1/2@...`, three scenes of 8 steps,
           APHANTASIA_FLEET_WAIT set): scenes [0, 2] and [1], rank 0
           assembles the piece, each scene's `.pt` equal to a one-process
           `--separate` run's; (af) `interpol` on (ae)'s snapshots as two
           processes without a coordinator (one from `--fleet 1/2`, one
           from APHANTASIA_FLEET=0/2), the frames equal to one process's
           byte for byte.  Every child is stopped when the phase ends.
  spatial  the spatial canvases (ROADMAP.md A.10b) through the CLIs'
           spatial set-up (`setup(a, spatial=1)`, `_run(a, spatial=1)`)
           on a spatial axis of one NCCL rank (the card's one GPU), at
           published widths: (ag) `clip_fft` at its defaults (ViT-B/32,
           1280x720, 190 cutouts, the chunked path, 8 steps) and (ah) the
           same with `--dwt` (coif2), each against the dense run: the
           spatial decode and float32 cut from the same params and draws
           (2e-4), each step's loss and gradient from the dense
           trajectory's params in float32 without augmentations (1e-5,
           1e-4; bf16 with `fast` printed), the eager steps twice and
           replayed from CUDA graphs, bit for bit, the collectives a step
           counted per replay, steady steps/s in turns and device ms a
           step by replay; (ai) `illustrip --gen FFT --depth 1` and (aj)
           `--gen RGB` at 95 cutouts (`--opt_step 2`): the first frame's
           warp, depth preview, loss and gradient against the dense frame
           step, eager frames twice against replayed ones, the collectives
           a frame, frames/min of the CLI spatial and dense; (ak) one
           frame group of `clip_fft --size 3840-2160`, spatial against
           dense: device ms by replay and peak memory.
  cudnn    (only when asked for) the (j) loop path with cuDNN's
           nondeterministic algorithms allowed: device ms and bits.
  profile  (only when asked for) torch.profiler over steady replayed steps
           (one step a dispatch, the loss read after each) of both
           cutout paths, the four augmentation paths of `main`, the
           switches' paths on ViT-B/32 and ViT-L/14, ViT-L/14 without them,
           and the fused-block paths (d) and (e) on ViT-B/32: device time
           by kernel, kernel launches per step and the device busy share
           (`--profile-paths '(d),(e)'` takes only those two).

The last three lines of standard output are one JSON object describing
every kernel, the card's name and power limit as nvidia-smi reports them,
and `{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
`aphantasia_torch` package beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and op/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}

# every kernel of the port: the C wrapper name in kernels.LAUNCHES ->
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
    "persp_fwd": ("aphantasia_torch/csrc/persp.cu",
                  "aphantasia_tpu/ops/pallas_persp.py:394"),
    "persp_bwd": ("aphantasia_torch/csrc/persp.cu",
                  "aphantasia_tpu/ops/pallas_persp.py:439"),
    "frac_shift": ("aphantasia_torch/csrc/shift.cu",
                   "aphantasia_tpu/ops/pallas_shift.py:73"),
    "win_cut_fwd": ("aphantasia_torch/csrc/cutout_win.cu",
                    "aphantasia_tpu/ops/pallas_cutout_win.py:128"),
    "ln_fwd": ("aphantasia_torch/csrc/ln.cu",
               "aphantasia_tpu/ops/pallas_ln.py:88"),
    "ln_bwd": ("aphantasia_torch/csrc/ln.cu",
               "aphantasia_tpu/ops/pallas_ln.py:114"),
    "block_attn_fwd": ("aphantasia_torch/csrc/block.cu",
                       "aphantasia_tpu/ops/pallas_block.py:273"),
    "block_attn_bwd": ("aphantasia_torch/csrc/block.cu",
                       "aphantasia_tpu/ops/pallas_block.py:298"),
    "block_mlp_fwd": ("aphantasia_torch/csrc/block.cu",
                      "aphantasia_tpu/ops/pallas_block.py:333"),
    "block_mlp_bwd": ("aphantasia_torch/csrc/block.cu",
                      "aphantasia_tpu/ops/pallas_block.py:358"),
}
BLOCK_KERNELS = ("block_attn_fwd", "block_attn_bwd", "block_mlp_fwd",
                 "block_mlp_bwd")


def b32(steps: int, text: int = 0, **more) -> dict:
    """The kernel launches of `steps` steps of the bf16 ViT-B/32 image
    tower on the card, whose blocks take the fused halves by default (one
    of each entry point a block and step, no attention kernel), with
    `text` attention forwards of the text towers (12 a prompt and tower)
    or a float32 image prompt (12), and the launches in `more`."""
    want = {k: 12 * steps for k in BLOCK_KERNELS}
    if text:
        want["attn_fwd"] = text
    want.update(more)
    return want


def dense_cut(steps: int) -> dict:
    """The launches of `steps` default bf16 cuts on the card (no --pallas,
    no windowed switch): the contraction kernel pair, one each way."""
    return {"contract_fwd": steps, "contract_bwd": steps}


def b32_dual(steps: int, second: int, text: int, **more) -> dict:
    """As `b32`, with `second` of the steps on ViT-B/16 (--dualmod), whose
    t = 197 keeps its blocks unfused: 12 attention launches each way."""
    want = b32(steps - second, text + 12 * second, **more)
    if second:
        want["attn_bwd"] = 12 * second
    return want

# the switches of the windowed cutout and the fused LayerNorm, and of the
# fused half blocks
SWITCHES = {"APHANTASIA_WIN_CUTOUT": "1", "APHANTASIA_PALLAS_LN": "1"}
WIN_ONLY = {"APHANTASIA_WIN_CUTOUT": "1"}
FUSED = {"APHANTASIA_FUSED_BLOCK": "1"}


class env_set:
    """Set environment variables for a `with` block, then restore them."""

    def __init__(self, env):
        self.env = env or {}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def capture(fn, iters: int = 1, warmup: int = 3):
    """(graph, result of the last captured call): `fn` called `warmup`
    times on a side stream, then `iters` calls captured into one CUDA
    graph.  Raises if `fn` cannot be captured (a host sync, a pageable
    host-to-device copy)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            out = fn()
    return graph, out


def graph_ms(fn, iters: int = 20, warmup: int = 3, replays: int = 5):
    """Mean device time of `fn` per call, with no profiler: `iters` calls
    captured into one CUDA graph (`capture`), replayed once to warm up,
    then CUDA events around `replays` further replays.  A replay launches
    the captured kernels back to back with no host work between them, so
    this is the card's own time on any machine."""
    import torch
    graph, _ = capture(fn, iters, warmup)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of `fn`: a host clock around `calls`
    back-to-back calls and one synchronise at the end (after 10 warm
    calls), so the enqueue cost is what is measured while the card keeps
    up."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Mean device time of the kernels `fn` launches, per call: the self
    device time torch.profiler records over `iters` calls (after `warmup`),
    over `iters`.  Unlike `cuda_ms` it counts no time the card waits for
    the host between launches.  None when the profiler records no device
    time (its CUPTI tracing is not available on every machine): the CUDA
    event times of `cuda_ms` then stand alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / iters if total > 0 else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


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
                    seed=0, timed=False, grad_tol=None):
    """Kernel against `attention_plain`: forward and d(qkv), the gradient
    within `grad_tol` relative (default five times the forward's).  Returns
    a dict with errors (and times when `timed`)."""
    import torch
    from aphantasia_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((rows, 3 * d), generator=g, device="cuda").to(dtype)
    dout = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
    out, lse = A.attention_fwd_kernel(qkv, heads, t, causal, valid_t)
    dqkv = A.attention_bwd_kernel(qkv, dout, out, lse, heads, t, causal,
                                  valid_t)
    again = A.attention_bwd_kernel(qkv, dout, out, lse, heads, t, causal,
                                   valid_t)
    q_req = qkv.clone().requires_grad_(True)
    ref = A.attention_plain(q_req, heads, t, causal, valid_t)
    (dref,) = torch.autograd.grad(ref, q_req, dout)
    torch.cuda.synchronize()
    check(torch.equal(again, dqkv),
          f"attention bwd {dtype} t={t}: two launches differ")
    vt = valid_t or t
    rowmask = (torch.arange(rows, device="cuda") % t) < vt
    fe, fs = max_err(out[rowmask], ref.detach()[rowmask])
    ge, gs = max_err(dqkv, dref)
    # bf16: both sides read the same bf16 inputs and sum in float32; the
    # kernel rounds p (and ds) to bf16 before their products, as the TPU
    # kernel does, and each side rounds its output once, so they part by a
    # rounding step of the output (2^-8 relative) plus p's roundings, at
    # most 2^-9 of each term and of random sign (tests/test_torch_gpu.py)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-5
    grad_tol = grad_tol or 5 * tol
    res = {"fwd_err": fe, "fwd_scale": fs, "grad_err": ge, "grad_scale": gs,
           "tol_rel": tol}
    check(math.isfinite(fe) and fe <= tol * max(fs, 1.0),
          f"attention fwd {dtype} t={t} causal={causal} valid_t={valid_t}: "
          f"max |err| {fe:.3g} > {tol:.3g} * {max(fs, 1.0):.3g}")
    check(math.isfinite(ge) and ge <= grad_tol * max(gs, 1.0),
          f"attention grad {dtype} t={t}: max |err| {ge:.3g} > "
          f"{grad_tol:.3g} * {max(gs, 1.0):.3g}")
    if not timed:
        return res
    import torch.nn.functional as F
    b = rows // t
    hd = d // heads

    def kern_fwd():
        return A.attention_fwd_kernel(qkv, heads, t, causal, valid_t)

    def kern_bwd():
        return A.attention_bwd_kernel(qkv, dout, out, lse, heads, t, causal,
                                      valid_t)
    res["ms_fwd"] = cuda_ms(kern_fwd)
    res["ms_bwd"] = cuda_ms(kern_bwd)
    res["dev_fwd"] = device_ms(kern_fwd)
    res["dev_bwd"] = device_ms(kern_bwd)
    res["graph_fwd"] = graph_ms(kern_fwd)
    res["graph_bwd"] = graph_ms(kern_bwd)
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

    def lib_fb():
        return torch.autograd.grad(sdpa(q_req), q_req, do4)
    res["lib_bwd"] = max(cuda_ms(lib_fb) - res["lib_fwd"], 0.0)
    res["dev_lib_fwd"] = device_ms(lambda: sdpa(qkv))
    lib_fb_dev = device_ms(lib_fb)
    res["dev_lib_bwd"] = (None if None in (lib_fb_dev, res["dev_lib_fwd"])
                          else max(lib_fb_dev - res["dev_lib_fwd"], 0.0))
    es = qkv.element_size()
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    pairs = b * heads * (t * (t + 1) // 2 if causal else t * vt)
    res["bound_fwd"] = bound(rows * 3 * d * es + rows * d * es
                             + rows * heads * 4, 4 * pairs * hd, kind)
    res["bound_bwd"] = bound(rows * 3 * d * es + 2 * rows * d * es
                             + rows * heads * 4 + rows * 3 * d * es,
                             10 * pairs * hd, kind)
    return res


def check_cutout(seed=0, s=200, m=224, align="uniform", h=720, w=1280):
    """Cutout kernels against `cutout_plain` on an h x w frame (1280x720
    unless given), S cutouts of M (the main path's 200 of 224; RN50x4's
    30 of 288 and RN50x64's one of 448 run the forward's column bands past
    256; illustrip's 95 of 224 with `overscan`'s folded taps; cppn's 47
    of 224 with overscan from 512x512; clip_vqgan's 190 of 224 from
    640x512); each also against itself, two launches and a CUDA-graph
    replay, bit for bit."""
    import torch
    from aphantasia_torch.ops import cutout as C
    from aphantasia_torch.ops.sampler import CutoutSampler, _contract
    g = torch.Generator(device="cuda").manual_seed(seed)
    sampler = CutoutSampler((h, w), s, m, align,
                            0.3 if align == "overscan" else 0.4)
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
    # the forward: both sides round the frame, the weights and the row
    # pass to bf16 and sum the distinct taps in ascending frame index; the
    # gradient: float32, each side summing in its own order
    tol_f, tol_g = 1e-5, 1e-4
    check(fe <= tol_f * max(fs, 1.0), f"cutout fwd: max |err| {fe:.3g}")
    check(ge <= tol_g * max(gs, 1.0), f"cutout grad: max |err| {ge:.3g}")
    for k, first, fn in (
            ("fwd", out, lambda: C.cutout_fwd_kernel(img, *taps)),
            ("bwd", dimg, lambda: C.cutout_bwd_kernel(
                gout, *taps, tuple(img.shape)))):
        again = fn()
        graph, replayed = capture(fn)
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(again, first) and torch.equal(replayed, first),
              f"cutout {k}: two launches or a graph replay differ in their "
              "bits")
        del graph, again, replayed
    res = {"fwd_err": fe, "fwd_scale": fs, "grad_err": ge, "grad_scale": gs,
           "tol_fwd": tol_f, "tol_grad": tol_g}
    del ref, dref
    res["ms_fwd"] = cuda_ms(lambda: C.cutout_fwd_kernel(img, *taps))
    res["ms_bwd"] = cuda_ms(lambda: C.cutout_bwd_kernel(
        gout, *taps, tuple(img.shape)))
    res["graph_fwd"] = graph_ms(lambda: C.cutout_fwd_kernel(img, *taps))
    res["graph_bwd"] = graph_ms(lambda: C.cutout_bwd_kernel(
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
    # how unevenly the crops load the backward's tiles: crops a tile meets
    rng = C.tile_ranges(*C.in_frame(taps[0], taps[1], h),
                        *C.in_frame(taps[2], taps[3], w), h, w)
    nby, nbx = -(-h // C.TILE), -(-w // C.TILE)
    hit_y = rng[:, :nby, 0] <= rng[:, :nby, 1]
    hit_x = rng[:, nby:nby + nbx, 0] <= rng[:, nby:nby + nbx, 1]
    per_tile = (hit_y[:, :, None] & hit_x[:, None, :]).sum(0).float()
    res["tile_crops"] = (per_tile.min().item(), per_tile.median().item(),
                         per_tile.max().item())
    tap_bytes = 4 * s * m * 4 * 4
    res["bound_fwd"] = bound(3 * h * w * 4 + tap_bytes + s * 3 * m * m * 4,
                             s * 3 * m * m * 40, "f32")
    res["bound_bwd"] = bound(s * 3 * m * m * 4 + tap_bytes + 3 * h * w * 4,
                             s * 3 * m * m * 40, "f32")
    return res


def check_contract(seed=0, s=190, m=224, align="uniform", h=720, w=1280):
    """The card's default bf16 cut (the contraction kernel pair,
    `contract_fwd_kernel` / `contract_bwd_kernel`) against its plain
    version `contract_plain`, bit for bit, forward and image gradient, on
    an h x w frame; each also against itself, two launches and a
    CUDA-graph replay.  Timed beside the plain version and the dense
    contraction it replaces (`_contract` at bf16: the dense matrices'
    build and the cuBLAS products)."""
    import torch
    from aphantasia_torch.ops import cutout as C
    from aphantasia_torch.ops.sampler import CutoutSampler, _contract
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    sampler = CutoutSampler((h, w), s, m, align, 0.4)
    boxes = sampler.sample_boxes(g)
    taps = sampler.tap_indices(boxes)
    img = torch.rand((3, h, w), generator=g, device="cuda")
    gout = torch.randn((s, 3, m, m), generator=g, device="cuda")
    fwd = lambda: C.contract_fwd_kernel(img, *taps)  # noqa: E731
    bwd = lambda: C.contract_bwd_kernel(gout, *taps, (3, h, w))  # noqa
    out, dimg = fwd(), bwd()
    i_req = img.clone().requires_grad_(True)
    ref = C.contract_plain(i_req, *taps)
    (dref,) = torch.autograd.grad(ref, i_req, gout)
    torch.cuda.synchronize()
    check(torch.equal(out, ref.detach()) and torch.equal(dimg, dref),
          f"contract {h}x{w} S={s}: kernel and plain version differ")
    for k, first, fn in (("fwd", out, fwd), ("bwd", dimg, bwd)):
        again = fn()
        graph, replayed = capture(fn)
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(again, first) and torch.equal(replayed, first),
              f"contract {k}: two launches or a graph replay differ in "
              "their bits")
        del graph, again, replayed
    del ref, dref
    res = {"ms_fwd": cuda_ms(fwd), "ms_bwd": cuda_ms(bwd),
           "graph_fwd": graph_ms(fwd), "graph_bwd": graph_ms(bwd)}
    res["plain_fwd"] = cuda_ms(lambda: C.contract_plain(img, *taps),
                               iters=3, warmup=1)
    plain_fb = cuda_ms(lambda: torch.autograd.grad(
        C.contract_plain(i_req, *taps), i_req, gout), iters=3, warmup=1)
    res["plain_bwd"] = max(plain_fb - res["plain_fwd"], 0.0)
    torch.cuda.empty_cache()

    def dense():
        return _contract(i_req, *sampler.weight_matrices(boxes, dtype=bf),
                         bf)
    res["lib_fwd"] = graph_ms(lambda: dense().detach(), iters=5)
    res["lib_bwd"] = max(graph_ms(lambda: torch.autograd.grad(
        dense(), i_req, gout)[0], iters=5) - res["lib_fwd"], 0.0)
    torch.cuda.empty_cache()
    # the benchmark's bound (benchmark/harness/flops.py:cut_bytes): the
    # frame and the cutouts once each way
    res["bound_fwd"] = bound(3 * h * w * 4 + s * 3 * m * m * 4, 0, "f32")
    res["bound_bwd"] = res["bound_fwd"]
    return res


def vqgan_ops(cfg, h, w):
    """(convolution, attention-product) operations of one forward of the
    VQGAN decoder to an h x w image, from its layers' shapes: 2 k^2 cin
    cout per output pixel of each convolution, 2 t^2 c for each of an
    attention's two products over its t tokens."""
    n = (h // cfg.f) * (w // cfg.f)
    conv = attn = 0

    def cv(cin, cout, k, n):
        return 2 * k * k * cin * cout * n

    def res(cin, cout, n):
        return (cv(cin, cout, 3, n) + cv(cout, cout, 3, n)
                + (cv(cin, cout, 1, n) if cin != cout else 0))

    cur = cfg.ch * cfg.ch_mult[-1]
    conv += cv(cfg.z_channels, cur, 3, n) + 2 * res(cur, cur, n) + 4 * cv(
        cur, cur, 1, n)
    attn += 4 * n * n * cur
    for level in reversed(range(len(cfg.ch_mult))):
        cout = cfg.ch * cfg.ch_mult[level]
        for _ in range(cfg.num_res_blocks + 1):
            conv += res(cur, cout, n)
            cur = cout
            if level == len(cfg.ch_mult) - 1:
                conv += 4 * cv(cur, cur, 1, n)
                attn += 4 * n * n * cur
        if level:
            n *= 4
            conv += cv(cur, cur, 3, n)
    conv += cv(cur, 3, 3, n)
    return conv, attn


def check_vqgan_decode(name="imagenet_f16_16384", h=480, w=640, seed=0):
    """The VQGAN decode alone at a CLI's size, random weights from a seed:
    the bf16 decode (the card's "auto") against the float32 one, within
    the JAX package's bound (mean |diff| / std(f32) < 0.05 and
    correlation > 0.995, tests/test_vqgan.py); then each dtype's forward
    and forward + latent gradient (what a step runs, the render aside) by
    graph replay, against the bound of its operations at the dtype's peak
    (the backward's data gradients: each convolution's again, each
    attention product's twice) or of its bytes (weights, latent and
    image); beside each, the same decode with PyTorch's `F.group_norm`
    (the library's GroupNorm, the first design) in place of the port's;
    and the bf16 forward's device time by torch.profiler (None where it
    records none)."""
    import torch
    import torch.nn.functional as F
    from aphantasia_torch.models import vqgan as V

    def library_gn(x, p, groups=32, eps=1e-6):
        return F.group_norm(x.float(), min(groups, x.shape[1]), p["g"],
                            p["b"], eps).to(x.dtype)
    cfg = V.VQGAN_CONFIGS[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    par32 = V.VQGANParameterizer((h, w), cfg, V.vqgan_init(g, cfg),
                                 torch.float32)
    z = par32.init(g)
    co = torch.randn((1, 3, h, w), generator=g, device="cuda")
    res = {"name": name, "h": h, "w": w}
    with torch.no_grad():
        f32 = par32.image(z)
        bf = V.VQGANParameterizer((h, w), cfg, par32.decoder_params,
                                  torch.bfloat16).image(z)
    res["err"] = ((bf - f32).abs().mean() / (f32.std() + 1e-9)).item()
    res["corr"] = torch.corrcoef(torch.stack([bf.flatten(),
                                              f32.flatten()]))[0, 1].item()
    res["saturated"] = ((f32 == 0) | (f32 == 1)).float().mean().item()
    check(res["err"] < 0.05 and res["corr"] > 0.995,
          f"vqgan {name}: bf16 decode vs float32 mean|diff|/std "
          f"{res['err']:.4f}, corr {res['corr']:.5f}")
    conv, attn = vqgan_ops(cfg, h, w)
    res["gflop_fwd"], res["gflop_step"] = ((conv + attn) / 1e9,
                                           (2 * conv + 3 * attn) / 1e9)
    nweights = sum(4 * t.numel() for t in _tree_leaves(par32.decoder_params))
    for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        par = V.VQGANParameterizer((h, w), cfg, par32.decoder_params, dt)
        par.decoder(dt)
        size = 2 if dt == torch.bfloat16 else 4
        xb = z.numel() * 4 + 3 * h * w * 4 + nweights // 4 * size

        def fwd():
            with torch.no_grad():
                return par.image(z)

        def step():
            x = z.detach().requires_grad_(True)
            return torch.autograd.grad(par.image(x), x, co)[0]
        res[f"fwd_{kind}"] = graph_ms(fwd, iters=5, replays=3)
        res[f"step_{kind}"] = graph_ms(step, iters=3, replays=3)
        if kind == "bf16":
            res["prof_fwd_bf16"] = device_ms(fwd, iters=3, warmup=1)
        own, V._group_norm = V._group_norm, library_gn
        try:
            res[f"lib_fwd_{kind}"] = graph_ms(fwd, iters=5, replays=3)
            res[f"lib_step_{kind}"] = graph_ms(step, iters=3, replays=3)
        finally:
            V._group_norm = own
        res[f"bound_fwd_{kind}"] = bound(xb, conv + attn, kind)
        res[f"bound_step_{kind}"] = bound(2 * xb, 2 * conv + 3 * attn, kind)
        del par
        torch.cuda.empty_cache()
    return res


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def persp_case(kind, s, h, w, seed=0):
    """(coef [S,8], flags [S]) of one warp case on the card: "persp" the
    `fast` draw (RandomPerspective(0.33), here with p = 0.7 so both kinds
    of sample are many; p = 0.2 as on the main path with "persp-main"),
    "rotate" +-30 deg rotations (every tenth angle 0, flag 0), "corners"
    the extreme integer corner draws of the distortion-0.33 family (the
    perspective window test of the JAX package, all flagged)."""
    import itertools
    import numpy as np
    import torch
    from aphantasia_torch.ops.perspective import (perspective_coeffs,
                                                  perspective_endpoints,
                                                  rotation_coeffs_for)
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind in ("persp", "persp-main"):
        start, end = perspective_endpoints(g, s, h, w, 0.33,
                                           0.2 if kind == "persp-main" else 0.7)
        flags = (end - start[None]).abs().amax((1, 2)) > 0
        return perspective_coeffs(start, end), flags.to(torch.int32)
    if kind == "rotate":
        ang = torch.linspace(-30.0, 30.0, s, device="cuda")
        ang[::10] = 0.0
        return rotation_coeffs_for(ang, h, w), (ang != 0).to(torch.int32)
    dw, dh = int(0.33 * (w // 2)), int(0.33 * (h // 2))
    los_his = [(0, dw), (0, dh), (w - dw - 1, w - 1), (0, dh),
               (w - dw - 1, w - 1), (h - dh - 1, h - 1),
               (0, dw), (h - dh - 1, h - 1)]
    pts = np.array(list(itertools.product(*los_his)), np.float32)
    pick = pts[np.random.RandomState(seed).choice(len(pts), s, replace=False)]
    end = torch.tensor(pick, device="cuda").reshape(s, 4, 2)
    start = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                         dtype=torch.float32, device="cuda")
    return (perspective_coeffs(start, end),
            torch.ones((s,), dtype=torch.int32, device="cuda"))


def _grid_sample_warp(img, coef):
    """The library yardstick: torchvision's own route, grid_sample (bilinear,
    zeros, align_corners=False) of the image with a ones channel appended,
    times the sampled mask.  Returns a function of the image."""
    import torch
    import torch.nn.functional as F
    from aphantasia_torch.ops.perspective import _grids, _src_positions
    s, c, h, w = img.shape
    xx, yy = _grids(h, w, img.device)
    sx, sy = _src_positions(coef, xx, yy)
    # float32 grid and image: a bf16 grid cannot hold the positions
    grid = torch.stack([(sx + 0.5) / w * 2 - 1, (sy + 0.5) / h * 2 - 1], -1)
    ones = torch.ones((s, 1, h, w), device=img.device)

    def warp(x):
        out = F.grid_sample(torch.cat([x.float(), ones], 1), grid,
                            mode="bilinear", padding_mode="zeros",
                            align_corners=False)
        return (out[:, :c] * out[:, c:]).to(x.dtype)
    return warp


def check_persp(kind, s, h, w, dtype, timed=False, seed=0):
    """Kernels A and B against `perspective_warp_plain` (forward) and
    autograd's transpose of it (d_img), at [S,3,H,W] in `dtype`."""
    import torch
    from aphantasia_torch.ops import persp as P
    coef, flags = persp_case(kind, s, h, w, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    img = torch.rand((s, 3, h, w), generator=g, device="cuda").to(dtype)
    gout = torch.randn((s, 3, h, w), generator=g, device="cuda").to(dtype)
    out = P.persp_fwd_kernel(img, coef, flags)
    dimg = P.persp_bwd_kernel(gout, coef, flags)
    again = P.persp_bwd_kernel(gout, coef, flags)
    i_req = img.clone().requires_grad_(True)
    ref = P.perspective_warp_plain(i_req, coef, flags)
    (dref,) = torch.autograd.grad(ref, i_req, gout)
    torch.cuda.synchronize()
    fe, fs = max_err(out, ref.detach())
    ge, gs = max_err(dimg, dref)
    keep = flags == 0
    copied = bool(torch.equal(out[keep], img[keep])
                  and torch.equal(dimg[keep], gout[keep]))
    # float32: the positions and the forward's sums are the plain version's
    # operations in its order; the backward sums in another order.  bf16:
    # both sides compute in float32 from the same bf16 inputs and round once
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    res = {"fwd_err": fe, "fwd_scale": fs, "grad_err": ge, "grad_scale": gs,
           "tol_rel": tol, "flagged": int(flags.sum().item())}
    check(copied, f"persp {kind} {dtype}: a flag-0 sample was not copied")
    check(torch.equal(again, dimg),
          f"persp bwd {kind} {dtype}: two launches differ")
    check(math.isfinite(fe) and fe <= tol * max(fs, 1.0),
          f"persp fwd {kind} {dtype} {h}x{w}: max |err| {fe:.3g}")
    check(math.isfinite(ge) and ge <= tol * max(gs, 1.0),
          f"persp grad {kind} {dtype} {h}x{w}: max |err| {ge:.3g}")
    if not timed:
        return res
    del ref, dref
    lib = _grid_sample_warp(img, coef)
    res["lib_err"] = max_err(torch.where(keep[:, None, None, None], img,
                                         lib(img)), out)[0]
    res["ms_fwd"] = cuda_ms(lambda: P.persp_fwd_kernel(img, coef, flags))
    res["ms_bwd"] = cuda_ms(lambda: P.persp_bwd_kernel(gout, coef, flags))
    res["graph_fwd"] = graph_ms(lambda: P.persp_fwd_kernel(img, coef, flags))
    res["graph_bwd"] = graph_ms(lambda: P.persp_bwd_kernel(gout, coef, flags))
    graph, replayed = capture(lambda: P.persp_bwd_kernel(gout, coef, flags))
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(replayed, dimg),
          f"persp bwd {kind} {dtype}: a graph replay differs")
    del graph
    res["plain_fwd"] = cuda_ms(lambda: P.perspective_warp_plain(
        img, coef, flags), iters=5)
    plain_fb = cuda_ms(lambda: torch.autograd.grad(P.perspective_warp_plain(
        i_req, coef, flags), i_req, gout), iters=5)
    res["plain_bwd"] = max(plain_fb - res["plain_fwd"], 0.0)
    res["lib_fwd"] = cuda_ms(lambda: lib(img), iters=5)
    lib_fb = cuda_ms(lambda: torch.autograd.grad(lib(i_req), i_req, gout),
                     iters=5)
    res["lib_bwd"] = max(lib_fb - res["lib_fwd"], 0.0)
    torch.cuda.empty_cache()
    nbytes = 2 * img.numel() * img.element_size() + s * 9 * 4
    # the function's float32 work per drawn pixel: the position (~14), the
    # four tap weights and the mask (~12) and 3 x (4 multiply-adds + 1)
    ops = res["flagged"] * h * w * (26 + 3 * 9)
    res["bound_fwd"] = bound(nbytes, ops, "f32")
    res["bound_bwd"] = bound(nbytes, ops, "f32")
    return res


def check_shift(rows, n_in, n, in_offset, out_window, timed=False, seed=0):
    """Kernel C against `frac_shift_plain` (forward) and autograd's
    transpose of it (d_x), float32, at random shifts of +-6 px."""
    import numpy as np
    import torch
    from aphantasia_torch.ops import shift as SH
    # the plain version's products in full float32, whatever the caller set
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, n_in), generator=g, device="cuda")
    sh = (torch.rand((rows,), generator=g, device="cuda") * 2 - 1) * 6.0
    gout = torch.randn((rows, out_window[1]), generator=g, device="cuda")
    out = SH.frac_shift_kernel(x, sh, n, in_offset, out_window)
    x_req = x.clone().requires_grad_(True)
    fn = SH._FracShiftFn.apply
    (dx,) = torch.autograd.grad(fn(x_req, sh, n, in_offset, out_window),
                                x_req, gout)
    ref = SH.frac_shift_plain(x_req, sh, n, in_offset, out_window)
    (dref,) = torch.autograd.grad(ref, x_req, gout)
    torch.cuda.synchronize()
    fe, fs = max_err(out, ref.detach())
    ge, gs = max_err(dx, dref)
    # 3xTF32 products keep float32's accuracy, summed in another order than
    # cuBLAS's; the phase's sin/cos in another library
    tol = 1e-4
    res = {"fwd_err": fe, "fwd_scale": fs, "grad_err": ge, "grad_scale": gs,
           "tol_rel": tol}
    check(math.isfinite(fe) and fe <= tol * max(fs, 1.0),
          f"frac_shift fwd {rows}x{n_in} n={n}: max |err| {fe:.3g}")
    check(math.isfinite(ge) and ge <= tol * max(gs, 1.0),
          f"frac_shift grad {rows}x{n_in} n={n}: max |err| {ge:.3g}")
    if not timed:
        return res
    del ref, dref
    res["ms"] = cuda_ms(lambda: SH.frac_shift_kernel(x, sh, n, in_offset,
                                                     out_window))
    res["graph"] = graph_ms(lambda: SH.frac_shift_kernel(x, sh, n, in_offset,
                                                         out_window))
    res["plain"] = cuda_ms(lambda: SH.frac_shift_plain(x, sh, n, in_offset,
                                                       out_window))
    # not one library call: the rfft -> phase -> irfft route, for scale only
    k = torch.arange(n // 2 + 1, dtype=torch.float32, device="cuda")
    phase = torch.polar(torch.ones((), device="cuda"),
                        -2.0 * np.pi * k * sh[:, None] / n)
    res["fft"] = cuda_ms(lambda: torch.fft.irfft(torch.fft.rfft(x, n=n)
                                                 * phase, n=n))
    nf2 = 2 * (n // 2 + 1)
    nbytes = 4 * rows * (n_in + out_window[1] + 1) + 4 * 2 * n * nf2
    # the design that runs: three tf32 products each on the 2nf packed
    # spectrum columns the function needs (not the kernel's padding); the
    # float32-FMA bound of the old design beside it
    res["bound"] = bound(nbytes, 3 * 2 * rows * nf2 * (n_in + out_window[1]),
                         "tf32")
    res["bound_f32"] = bound(nbytes, 2 * rows * (n_in * nf2
                                                 + nf2 * out_window[1])
                             + 6 * rows * nf2, "f32")
    return res


def win_case(kind, dtype, seed=0):
    """(frame, boxes, sampler) of a windowed-cutout case on the card:
    "main" the main path's sampler (190 cutouts at 224 of 720x1280, the
    three tiers), "narrow" a 200x300 frame (not a multiple of 8 columns:
    the TMA maps read a padded copy), "edge" 720x1280 boxes pushed to the
    bottom-right corner (windows clipped there), "m336" 40 cutouts at 336
    (ViT-L/14@336px's input: two 224-column tiles)."""
    import torch
    from aphantasia_torch.ops.sampler import Boxes, CutoutSampler
    h, w, s = (200, 300, 40) if kind == "narrow" else (720, 1280, 190)
    m = 224
    if kind in ("m336", "m288"):
        s, m = (40, 336) if kind == "m336" else (30, 288)
    g = torch.Generator(device="cuda").manual_seed(seed)
    sampler = CutoutSampler((h, w), s, m, "uniform", 0.4)
    boxes = sampler.sample_boxes(g)
    if kind == "edge":
        boxes = Boxes(boxes.csize, w - boxes.csize, h - boxes.csize)
    img = torch.rand((3, h, w), generator=g, device="cuda").to(dtype)
    return img, boxes, sampler


def check_win_cutout(kind, dtype, timed=False, seed=0):
    """The windowed-cutout kernel against `windowed_cut_fwd_plain`, in bf16
    from an intermediate scratch filled with NaN (the kernel must never
    read what it did not write), and, when `timed`, its event and
    graph-replay times beside the plain version, the port's dense bf16
    contraction (`_contract` forward) and the bound; then a windowed
    `sampler.cut` captured into a CUDA graph, whose replay must equal the
    eager cut bit for bit."""
    import torch
    from aphantasia_torch.ops import cutout_win as W
    from aphantasia_torch.ops.sampler import _contract
    img, boxes, sampler = win_case(kind, dtype, seed)
    c, h, w = img.shape
    m = sampler.modsize
    wyw, wxt = sampler.weight_matrices_windowed(boxes, dtype=dtype)
    plan = W.tier_plan(h, w, m)
    t1 = None
    if dtype == torch.bfloat16:
        t1 = torch.full((len(boxes.csize), c, plan[-1][1], -(-m // 8) * 8),
                        float("nan"), dtype=dtype, device="cuda")
    out = W.windowed_cut_fwd_kernel(img, boxes, wyw, wxt, m, dtype, t1=t1)
    again = W.windowed_cut_fwd_kernel(img, boxes, wyw, wxt, m, dtype)
    ref = W.windowed_cut_fwd_plain(img, boxes, wyw, wxt, m, dtype)
    torch.cuda.synchronize()
    check(torch.equal(out, again),
          f"win_cut_fwd {kind} {dtype}: two launches differ")
    del t1, again
    fe, fs = max_err(out, ref)
    tier = W.window_bases(boxes, h, w, m)[0]
    tiers = torch.bincount(tier.long(), minlength=3).tolist()
    # float32: the same products summed in another order; bf16: both sides
    # sum in float32 and round the intermediate to bf16, where a sum near a
    # rounding boundary may round the other way: one bf16 step
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    res = {"fwd_err": fe, "fwd_scale": fs, "tol_rel": tol, "tiers": tiers,
           "s": len(tier), "m": m}
    check(math.isfinite(fe) and fe <= tol * max(fs, 1.0),
          f"win_cut_fwd {kind} {dtype}: max |err| {fe:.3g}")
    if not timed:
        return res
    del ref

    def kern():
        return W.windowed_cut_fwd_kernel(img, boxes, wyw, wxt, m, dtype)
    res["ms"] = cuda_ms(kern)
    res["graph"] = graph_ms(kern)
    res["plain"] = cuda_ms(lambda: W.windowed_cut_fwd_plain(
        img, boxes, wyw, wxt, m, dtype), iters=5)
    wy, wx = sampler.weight_matrices(boxes, dtype=dtype)
    res["lib"] = cuda_ms(lambda: _contract(img, wy, wx, dtype), iters=5)
    res["graph_lib"] = graph_ms(lambda: _contract(img, wy, wx, dtype),
                                iters=5)
    del wy, wx
    torch.cuda.empty_cache()
    # the whole windowed cut (bases, weights, kernel) under the switch
    with env_set(WIN_ONLY):
        eager = sampler.cut(img, boxes, compute_dtype=dtype)
        graph, replayed = capture(
            lambda: sampler.cut(img, boxes, compute_dtype=dtype))
        graph.replay()
        torch.cuda.synchronize()
    check(torch.equal(replayed, eager),
          f"win_cut_fwd {kind}: the captured cut differs from the eager one")
    del graph, replayed, eager
    torch.cuda.empty_cache()
    ops = sum(n * (2 * c * kh * kw * m + 2 * c * m * kh * m)
              for n, (_, kh, kw) in zip(tiers, plan))
    es = img.element_size()
    nbytes = (img.numel() + wyw.numel() + wxt.numel()) * es \
        + out.numel() * 4 + 3 * 4 * len(tier)
    res["bound"] = bound(nbytes, ops, "bf16" if es == 2 else "f32")
    res["gflop"] = ops / 1e9
    return res


def check_ln(rows, d, dtype, timed=False, seed=0):
    """The LayerNorm kernels against `ln_fwd_plain` / `ln_bwd_plain` (y,
    stat, dx, dg, db), and, when `timed`, their times beside the plain
    versions, `F.layer_norm` and `native_layer_norm_backward`, and the
    bounds."""
    import torch
    import torch.nn.functional as F
    from aphantasia_torch.ops import ln as L
    g_ = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=g_, device="cuda") * 2
         + 0.5).to(dtype)
    g = torch.randn((d,), generator=g_, device="cuda") * 0.5 + 1.0
    b = torch.randn((d,), generator=g_, device="cuda") * 0.1
    dy = torch.randn((rows, d), generator=g_, device="cuda").to(dtype)
    y, stat = L.ln_fwd_kernel(x, g, b)
    dx, dg, db = L.ln_bwd_kernel(x, g, stat, dy)
    yr, sr = L.ln_fwd_plain(x, g, b)
    dxr, dgr, dbr = L.ln_bwd_plain(x, g, sr, dy)
    again = L.ln_bwd_kernel(x, g, stat, dy)
    torch.cuda.synchronize()
    # y and dx: one rounding to the output dtype on each side (bf16: one
    # step); stat, dg, db: float32 sums in another order
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    errs = {k: max_err(a, r) for k, a, r in (
        ("y", y, yr), ("stat", stat, sr), ("dx", dx, dxr), ("dg", dg, dgr),
        ("db", db, dbr))}
    for k, (e, sc) in errs.items():
        lim = (tol if k in ("y", "dx") else 1e-5) * max(sc, 1.0)
        check(math.isfinite(e) and e <= lim,
              f"ln {k} [{rows},{d}] {dtype}: max |err| {e:.3g} > {lim:.3g}")
    check(all(torch.equal(a, b_) for a, b_ in zip(again, (dx, dg, db))),
          f"ln_bwd [{rows},{d}] {dtype}: two runs differ")
    res = {"errs": errs, "tol_rel": tol,
           "fwd_err": max(errs["y"][0], errs["stat"][0]),
           "bwd_err": max(errs[k][0] for k in ("dx", "dg", "db"))}
    if not timed:
        return res
    res["ms_fwd"] = cuda_ms(lambda: L.ln_fwd_kernel(x, g, b))
    res["ms_bwd"] = cuda_ms(lambda: L.ln_bwd_kernel(x, g, stat, dy))
    res["plain_fwd"] = cuda_ms(lambda: L.ln_fwd_plain(x, g, b))
    res["plain_bwd"] = cuda_ms(lambda: L.ln_bwd_plain(x, g, stat, dy))
    gl, bl = g.to(dtype), b.to(dtype)
    res["lib_fwd"] = cuda_ms(lambda: F.layer_norm(x, (d,), gl, bl, 1e-5))
    res["graph_fwd"] = graph_ms(lambda: L.ln_fwd_kernel(x, g, b))
    res["graph_bwd"] = graph_ms(lambda: L.ln_bwd_kernel(x, g, stat, dy))
    res["graph_lib_fwd"] = graph_ms(lambda: F.layer_norm(x, (d,), gl, bl,
                                                         1e-5))
    # the wrappers' host cost per call (the card keeps up with both)
    res["host_fwd"] = host_us(lambda: L.ln_fwd_kernel(x, g, b))
    res["host_lib_fwd"] = host_us(lambda: F.layer_norm(x, (d,), gl, bl,
                                                       1e-5))
    # the library's backward as one call: dx, dg and db, the weight in
    # x's dtype, from the saved mean and rstd
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], gl, bl, 1e-5)

    def lib_bwd():
        return torch.ops.aten.native_layer_norm_backward(
            dy, x, [d], mean, rstd, gl, bl, [True, True, True])
    res["lib_bwd"] = cuda_ms(lib_bwd)
    res["graph_lib_bwd"] = graph_ms(lib_bwd)
    es = x.element_size()
    n = rows * d
    # forward: x in, y out, g/b in, (mu, rstd) out; ~8 float32 operations
    # per element (square-add, add, subtract, two multiplies, add, cast);
    # backward: x and dy in, dx out, g and stat in, dg/db out; ~14 each
    res["bound_fwd"] = bound(2 * n * es + 2 * d * 4 + rows * 8, 8 * n, "f32")
    res["bound_bwd"] = bound(3 * n * es + d * 4 + rows * 8 + 2 * d * 4,
                             14 * n, "f32")
    return res


def block_case(rows, d, dtype, seed=0):
    """x, dy [rows, d] in `dtype` and one block's params on the card, at
    the JAX `_block_init` scales with non-zero biases and LayerNorm
    affines (g, b float32; the rest cast to `dtype`, as `cast_weights`)."""
    import torch
    from aphantasia_torch.models.clip.model import cast_weights
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    def ln():
        return {"g": 1.0 + n(d, std=0.1), "b": n(d, std=0.1)}
    p = {"ln_1": ln(), "ln_2": ln(),
         "attn": {"in_w": n(d, 3 * d, std=d ** -0.5),
                  "in_b": n(3 * d, std=0.02),
                  "out_w": n(d, d, std=d ** -0.5), "out_b": n(d, std=0.02)},
         "mlp": {"fc_w": n(d, 4 * d, std=(2 * d) ** -0.5),
                 "fc_b": n(4 * d, std=0.02),
                 "proj_w": n(4 * d, d, std=d ** -0.5),
                 "proj_b": n(d, std=0.02)}}
    return n(rows, d).to(dtype), n(rows, d).to(dtype), cast_weights(p, dtype)


def check_block(rows, t, d, heads, dtype, timed=False, seed=0):
    """The four half-block kernels against their plain versions (y and
    lse forward, dx backward from the same lse), and, when `timed`, their
    times beside the plain versions, the port's unfused half (cuBLAS
    products, the attention kernel, plain LayerNorms; forward and
    autograd backward) and the bounds."""
    import torch
    from aphantasia_torch.models.clip import model as M
    from aphantasia_torch.ops import block as B
    x, dy, p = block_case(rows, d, dtype, seed)
    a, m = p["attn"], p["mlp"]
    aw = (p["ln_1"]["g"], p["ln_1"]["b"], a["in_w"], a["in_b"], a["out_w"])
    mw = (p["ln_2"]["g"], p["ln_2"]["b"], m["fc_w"], m["fc_b"], m["proj_w"])
    runs = {
        "block_attn_fwd": (
            lambda: B.attn_half_fwd_kernel(x, *aw, a["out_b"], heads, t),
            lambda: B.attn_half_fwd_plain(x, *aw, a["out_b"], heads, t)),
        "block_mlp_fwd": (
            lambda: B.mlp_half_fwd_kernel(x, *mw, m["proj_b"]),
            lambda: B.mlp_half_fwd_plain(x, *mw, m["proj_b"]))}
    (y, lse), (yr, lser) = (f() for f in runs["block_attn_fwd"])
    runs["block_attn_bwd"] = (
        lambda: B.attn_half_bwd_kernel(x, dy, lser, *aw, heads, t),
        lambda: B.attn_half_bwd_plain(x, dy, lser, *aw, heads, t))
    runs["block_mlp_bwd"] = (
        lambda: B.mlp_half_bwd_kernel(x, dy, *mw),
        lambda: B.mlp_half_bwd_plain(x, dy, *mw))
    outs = {"block_attn_fwd": (y, yr), "block_attn_lse": (lse, lser)}
    for k in ("block_mlp_fwd", "block_attn_bwd", "block_mlp_bwd"):
        outs[k] = tuple(f() for f in runs[k])
    # every entry point launched twice gives the same bits (no split-K, no
    # atomics, every sum in a fixed order)
    firsts = {"block_attn_fwd": (y, lse)}
    for k in BLOCK_KERNELS:
        again = runs[k][0]()
        first = firsts.get(k, outs[k][0])
        same = (all(torch.equal(u, v) for u, v in zip(again, first))
                if isinstance(again, tuple) else torch.equal(again, first))
        check(same, f"{k} [{rows},{d}] t={t} {dtype}: two launches differ")
    if dtype == torch.bfloat16:
        # the tensor-core attention cores alone, from the plain qkv and do
        h = B._ln(x, *aw[:2])[0]
        qkv = B._mm_bias(h, a["in_w"], a["in_b"])
        do = B._mm_t(dy, a["out_w"]).to(dtype)
        o_k, lse_k = B.core_fwd_kernel(qkv, heads, t)
        o_r, lse_r = B._attn_core_fwd(qkv, heads, t)
        outs["block_core_fwd"] = (o_k, o_r)
        # the row sums take the float32 e in both: float32 sums in another
        # order only (a sum of the bf16-rounded e drifts by ~1e-4), so lse
        # within 1e-5 (1e-5 relative on the sums)
        err = (lse_k - lse_r).abs().max().item()
        check(err <= 1e-5, f"block_core_fwd [{rows},{d}] t={t}: lse "
              f"error {err:.3g} > 1e-5")
        outs["block_core_bwd"] = (B.core_bwd_kernel(qkv, do, lser, heads, t),
                                  B._attn_core_bwd(qkv, do, lser, heads, t))
    torch.cuda.synchronize()
    # float32: the same operations, products summed in another order
    # through a chain of up to six products; bf16: both sides round at the
    # same points, but a float32 sum in another order can put an
    # intermediate on the other side of a bf16 rounding boundary, and the
    # output's own rounding may show that once more: two bf16 steps
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    errs = {k: max_err(*v) for k, v in outs.items()}
    for k, (e, sc) in errs.items():
        check(math.isfinite(e) and e <= tol * max(sc, 1.0),
              f"{k} [{rows},{d}] t={t} {dtype}: max |err| {e:.3g} > "
              f"{tol:.3g} * {max(sc, 1.0):.3g}")
    res = {"errs": errs, "tol_rel": tol}
    if not timed:
        return res
    del outs
    res["fwd_launches"] = block_fwd_launches(x, p, heads, t)
    res["launches"] = block_bwd_launches(x, dy, p, heads, t, lser)
    for k, (kern, plain) in runs.items():
        res[k] = {"ms": cuda_ms(kern), "graph": graph_ms(kern),
                  "plain": cuda_ms(plain, iters=5)}
    ln1, ln2 = p["ln_1"], p["ln_2"]
    unfused = {
        "block_attn_fwd": lambda v: v + M.mha_flat(M.layer_norm(v, ln1), a,
                                                   heads, t),
        "block_mlp_fwd": lambda v: v + M._mlp(M.layer_norm(v, ln2), m)}
    xr = x.clone().requires_grad_(True)
    with env_set({"APHANTASIA_PALLAS_LN": "0"}):
        for k, fn in unfused.items():
            fwd = cuda_ms(lambda: fn(x), iters=10)
            fb = cuda_ms(lambda: torch.autograd.grad(fn(xr), xr, dy),
                         iters=10)
            res[k]["unfused"] = fwd
            res[k.replace("fwd", "bwd")]["unfused"] = max(fb - fwd, 0.0)
    torch.cuda.empty_cache()
    es = x.element_size()
    kind = "bf16" if es == 2 else "f32"
    hid = 4 * d
    core = 2 * (rows // t) * heads * t * t * (d // heads)  # one t x t product
    act = rows * d * es
    w_attn = (3 * d * d + 3 * d + d * d + d) * es + 2 * d * 4
    w_mlp = (2 * d * hid + hid + d) * es + 2 * d * 4
    inv_bytes = rows * heads * 4
    # (bytes: inputs read once, outputs written once; operations: the
    # products, 2 per multiply-add)
    work = {
        "block_attn_fwd": (2 * act + inv_bytes + w_attn,
                           2 * rows * d * 4 * d + 2 * core),
        "block_attn_bwd": (3 * act + inv_bytes + w_attn - d * es,
                           2 * rows * d * 7 * d + 5 * core),
        "block_mlp_fwd": (2 * act + w_mlp, 4 * rows * d * hid),
        "block_mlp_bwd": (3 * act + w_mlp - d * es, 6 * rows * d * hid)}
    for k, (nbytes, ops) in work.items():
        res[k]["bound"] = bound(nbytes, ops, kind)
        res[k]["gflop"] = ops / 1e9
    return res


def block_fwd_launches(x, p, heads, t):
    """Each launch inside the bf16 forward chains of `attn_half_fwd` and
    `mlp_half_fwd` but the LayerNorms, alone at this shape, on inputs from
    the plain chain: {label: ({tile width: device ms by graph replay},
    yardstick ms, yardstick name, GFLOP, max |err| against its plain
    version, |ref|)}; each product at both tile widths (the chain runs
    the widths block.cu's kQkvBN .. kProjBN name), the core once (width
    0).  Beside each product `torch.matmul` at the same shape (the port
    never calls it), beside the core csrc/attention.cu's bf16 attention
    forward on the same qkv (lse softmax, another function).  Raises if a
    launch disagrees with its plain version by more than 2^-6 of |ref|."""
    import torch
    from aphantasia_torch.ops import attention as A
    from aphantasia_torch.ops import block as B
    a, m = p["attn"], p["mlp"]
    r, d = x.shape
    h1 = B._ln(x, p["ln_1"]["g"], p["ln_1"]["b"])[0]
    h2 = B._ln(x, p["ln_2"]["g"], p["ln_2"]["b"])[0]
    qkv = B._mm_bias(h1, a["in_w"], a["in_b"])
    o, _ = B._attn_core_fwd(qkv, heads, t)
    act = B.product_plain(h2, m["fc_w"], "bias_gelu", m["fc_b"])
    core_flop = 2 * 2 * (r // t) * heads * t * t * (d // heads)
    prods = (("qkv = h in_w + in_b", h1, a["in_w"], "bias", a["in_b"], None),
             ("y = x + o out_w + out_b", o, a["out_w"], "bias_residual",
              a["out_b"], x),
             ("a = gelu(h fc_w + fc_b)", h2, m["fc_w"], "bias_gelu",
              m["fc_b"], None),
             ("y = x + a p_w + p_b", act, m["proj_w"], "bias_residual",
              m["proj_b"], x))
    res = {}
    for label, lhs, w, kind, bias, aux in prods:
        ref = B.product_plain(lhs, w, kind, bias, aux)
        ms, err = {}, (0.0, 0.0)
        for width in (256, 128):
            kern = lambda: B.product_kernel(  # noqa: E731
                lhs, w, kind, bias, aux, width)
            e = max_err(kern(), ref)
            err = max(err, e)
            ms[width] = graph_ms(kern)
        gflop = 2 * lhs.shape[0] * lhs.shape[1] * w.shape[1] / 1e9
        res[label] = (ms, graph_ms(lambda: torch.matmul(lhs, w)),
                      "torch.matmul", gflop) + err
    err = max_err(B.core_fwd_kernel(qkv, heads, t)[0], o)
    res["core"] = ({0: graph_ms(lambda: B.core_fwd_kernel(qkv, heads, t))},
                   graph_ms(lambda: A.attention_fwd_kernel(qkv, heads, t)),
                   "attention.cu attn_fwd", core_flop / 1e9) + err
    for label, (*_, e, sc) in res.items():
        check(math.isfinite(e) and e <= 2.0 ** -6 * max(sc, 1.0),
              f"block forward launch {label}: max |err| {e:.3g} "
              f"(|ref| {sc:.3g})")
    return res


def block_bwd_launches(x, dy, p, heads, t, lse):
    """Each launch inside the bf16 backward chains of `attn_half_bwd` and
    `mlp_half_bwd`, alone at this shape, on inputs from the plain chain:
    {label: (device ms by graph replay, yardstick ms, yardstick name,
    GFLOP, max |err| against its plain version, |ref|)}.  Beside each
    product `torch.matmul` at the same shape (the port never calls it),
    beside the core csrc/attention.cu's bf16 attention backward on the
    same qkv (lse softmax, another function).  Raises if a launch
    disagrees with its plain version by more than 2^-6 of |ref|."""
    import torch
    from aphantasia_torch.ops import attention as A
    from aphantasia_torch.ops import block as B
    a, m = p["attn"], p["mlp"]
    r, d = x.shape
    h1 = B._ln(x, p["ln_1"]["g"], p["ln_1"]["b"])[0]
    h2 = B._ln(x, p["ln_2"]["g"], p["ln_2"]["b"])[0]
    qkv = B._mm_bias(h1, a["in_w"], a["in_b"])
    do = B._mm_t(dy, a["out_w"]).to(x.dtype)
    dqkv = B._attn_core_bwd(qkv, do, lse, heads, t)
    u = B._mm_bias(h2, m["fc_w"], m["fc_b"])
    du = B.product_plain(dy, m["proj_w"], "gelu_back", aux=u)
    out, lse = A.attention_fwd_kernel(qkv, heads, t)
    core_flop = 5 * 2 * (r // t) * heads * t * t * (d // heads)
    prods = (("qkv = h in_w + in_b", h1, a["in_w"], "bias", a["in_b"],
              None),
             ("do = dy out_w^T", dy, a["out_w"], "store", None, None),
             ("dh = dqkv in_w^T", dqkv, a["in_w"], "store_f32", None, None),
             ("u = h fc_w + fc_b", h2, m["fc_w"], "bias", m["fc_b"], None),
             ("du = gelu'(u) dy p_w^T", dy, m["proj_w"], "gelu_back", None,
              u),
             ("dh = du fc_w^T", du, m["fc_w"], "store_f32", None, None))
    res = {}
    for label, lhs, w, kind, bias, aux in prods:
        wt = w if kind == "bias" else w.t()
        kern = lambda: B.product_kernel(lhs, w, kind, bias, aux)  # noqa: E731
        err = max_err(kern(), B.product_plain(lhs, w, kind, bias, aux))
        gflop = 2 * lhs.shape[0] * lhs.shape[1] * wt.shape[1] / 1e9
        res[label] = (graph_ms(kern), graph_ms(lambda: torch.matmul(lhs, wt)),
                      "torch.matmul", gflop) + err
    err = max_err(B.core_bwd_kernel(qkv, do, lse, heads, t), dqkv)
    res["core"] = (graph_ms(lambda: B.core_bwd_kernel(qkv, do, lse, heads, t)),
                   graph_ms(lambda: A.attention_bwd_kernel(qkv, do, out, lse,
                                                           heads, t)),
                   "attention.cu attn_bwd", core_flop / 1e9) + err
    for label, (*_, e, sc) in res.items():
        check(math.isfinite(e) and e <= 2.0 ** -6 * max(sc, 1.0),
              f"block backward launch {label}: max |err| {e:.3g} "
              f"(|ref| {sc:.3g})")
    return res


def entry_name(line: str) -> str:
    """The kernel a ptxas `Compiling entry function '<mangled>'` line
    names: the length-prefixed part of the mangled name that ends in
    `_kernel`, else the line's first 48 characters."""
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", line):
        n, rest = int(m.group(1)), m.group(2)
        if len(rest) >= n and rest[:n].endswith("_kernel"):
            return rest[:n]
    return line.strip()[:48]


def phase_kernels(report):
    import torch
    from aphantasia_torch import kernels
    t0 = time.time()
    kernels.build_all()
    print(f"[kernels] built {', '.join(kernels.SOURCES)} in "
          f"{time.time() - t0:.1f} s")
    for name, log in kernels.BUILD_LOGS.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = entry_name(line)
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"[kernels] {name}: {fn}: {line.strip()}")
    bf16 = torch.bfloat16
    cases = [
        ("vision flat bf16", dict(rows=10000, t=50, d=768, heads=12,
                                  dtype=torch.bfloat16, timed=True)),
        ("vision flat f32", dict(rows=10000, t=50, d=768, heads=12,
                                 dtype=torch.float32, timed=True)),
        ("text causal f32", dict(rows=2 * 77, t=77, d=512, heads=8,
                                 dtype=torch.float32, causal=True)),
        ("padded valid_t bf16", dict(rows=16 * 64, t=64, d=768, heads=12,
                                     dtype=torch.bfloat16, valid_t=50)),
        ("vit-b/16 t=197 f32", dict(rows=4 * 197, t=197, d=768, heads=12,
                                    dtype=torch.float32)),
        ("vit-l/14 t=257 f32", dict(rows=4 * 257, t=257, d=1024, heads=16,
                                    dtype=torch.float32, timed=True)),
        # the float32 tiles walk keys 64 at a time: ViT-L/14@336px's 577
        # tokens, and 16 key tiles with valid_t inside the last
        ("vit-l/14@336 4x577x3072 f32", dict(rows=4 * 577, t=577, d=1024,
                                             heads=16, dtype=torch.float32,
                                             timed=True, grad_tol=2e-5)),
        ("t=1024 valid_t=1000 f32", dict(rows=2 * 1024, t=1024, d=512,
                                         heads=8, dtype=torch.float32,
                                         valid_t=1000, grad_tol=2e-5)),
        ("text causal 1x77x1536 f32", dict(rows=77, t=77, d=512, heads=8,
                                           dtype=torch.float32, causal=True,
                                           timed=True)),
        ("vit-b/16 47x197x2304 bf16", dict(rows=47 * 197, t=197, d=768,
                                           heads=12, dtype=torch.bfloat16,
                                           timed=True)),
        # the bf16 tensor-core tiles: one row short of, exactly and one
        # row past a 64-row tile, three key tiles with valid_t inside the
        # second, the text tower, ViT-L/14's main path and the 336 px tower
        ("t=63 bf16", dict(rows=8 * 63, t=63, d=768, heads=12, dtype=bf16)),
        ("t=64 bf16", dict(rows=8 * 64, t=64, d=768, heads=12, dtype=bf16)),
        ("t=65 bf16", dict(rows=8 * 65, t=65, d=768, heads=12, dtype=bf16)),
        ("t=129 valid_t=100 bf16", dict(rows=8 * 129, t=129, d=768,
                                        heads=12, dtype=bf16, valid_t=100)),
        ("text causal 1x77x1536 bf16", dict(rows=77, t=77, d=512, heads=8,
                                            dtype=bf16, causal=True,
                                            timed=True)),
        ("vit-l/14 7x257x3072 bf16", dict(rows=7 * 257, t=257, d=1024,
                                          heads=16, dtype=bf16, timed=True)),
        ("vit-l/14@336 4x577x3072 bf16", dict(rows=4 * 577, t=577, d=1024,
                                              heads=16, dtype=bf16,
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
                  f"{r['ms_' + k]:.4f} ms (device {fmt_ms(r['dev_' + k])}, "
                  f"graph replay {r['graph_' + k]:.4f}), "
                  f"plain {r['plain_' + k]:.4f} ms, sdpa {r['lib_' + k]:.4f} "
                  f"ms (device {fmt_ms(r['dev_lib_' + k])}), bound "
                  f"{r['bound_' + k][0]:.4f} ms ({r['bound_' + k][1]})")
        if label == "vision flat bf16":
            att = r
    cut = check_cutout()
    print(f"[kernels] cutout fwd max|err| {cut['fwd_err']:.3g} (|ref| "
          f"{cut['fwd_scale']:.3g}), grad max|err| {cut['grad_err']:.3g} "
          f"(|ref| {cut['grad_scale']:.3g}); both repeat bit for bit (two "
          f"launches, a graph replay); crops a 32x32 tile meets: "
          f"min {cut['tile_crops'][0]:.0f}, median {cut['tile_crops'][1]:.0f}"
          f", max {cut['tile_crops'][2]:.0f}")
    cut_err = {"fwd": cut["fwd_err"], "bwd": cut["grad_err"]}
    for ns, m, align, h, w in ((200, 224, "uniform", 720, 1280),
                               (30, 288, "uniform", 720, 1280),
                               (1, 448, "uniform", 720, 1280),
                               (95, 224, "overscan", 720, 1280),
                               (47, 224, "overscan", 512, 512),
                               (190, 224, "uniform", 512, 640)):
        r = cut if ns == 200 else check_cutout(s=ns, m=m, align=align, h=h,
                                               w=w)
        if ns != 200:
            print(f"[kernels] cutout S={ns} M={m} {align} {h}x{w}: fwd "
                  f"max|err| "
                  f"{r['fwd_err']:.3g} (|ref| {r['fwd_scale']:.3g}), grad "
                  f"max|err| {r['grad_err']:.3g} (|ref| "
                  f"{r['grad_scale']:.3g}); both repeat bit for bit")
            cut_err = {"fwd": max(cut_err["fwd"], r["fwd_err"]),
                       "bwd": max(cut_err["bwd"], r["grad_err"])}
        for k in ("fwd", "bwd"):
            print(f"[kernels] cutout {k} S={ns} M={m} {align} {h}x{w}: "
                  f"kernel {r['ms_' + k]:.4f} ms (graph replay "
                  f"{r['graph_' + k]:.4f}), plain {r['plain_' + k]:.4f} ms, "
                  f"einsum {r['lib_' + k]:.4f} ms, bound "
                  f"{r['bound_' + k][0]:.4f} ms ({r['bound_' + k][1]})")
    for h, w in ((720, 1280), (2160, 3840)):
        r = check_contract(h=h, w=w)
        for k in ("fwd", "bwd"):
            print(f"[kernels] contract {k} S=190 M=224 {h}x{w}: kernel "
                  f"{r['ms_' + k]:.4f} ms (graph replay "
                  f"{r['graph_' + k]:.4f}), plain {r['plain_' + k]:.4f} ms, "
                  f"_contract bf16 {r['lib_' + k]:.4f} ms (graph replay), "
                  f"bound {r['bound_' + k][0]:.4f} ms "
                  f"({r['bound_' + k][1]}); bit for bit the plain version")
    for name, h, w in (("imagenet_f16_16384", 480, 640),
                       ("gumbel_f8_8192", 512, 640)):
        r = check_vqgan_decode(name, h, w)
        print(f"[kernels] vqgan decode {name} {w}x{h}: bf16 vs float32 "
              f"mean|diff|/std {r['err']:.4f} (< 0.05), corr "
              f"{r['corr']:.5f} (> 0.995), {r['saturated']:.3f} of the "
              f"float32 pixels clamped; forward {r['gflop_fwd']:.1f} GFLOP, "
              f"forward + latent gradient {r['gflop_step']:.1f} GFLOP")
        for k in ("fwd", "step"):
            for kind in ("bf16", "f32"):
                ms, (bms, by) = r[f"{k}_{kind}"], r[f"bound_{k}_{kind}"]
                gf = r["gflop_fwd" if k == "fwd" else "gflop_step"]
                print(f"[kernels] vqgan {k} {name} {w}x{h} {kind}: graph "
                      f"replay {ms:.4f} ms ({gf / ms:.1f} TFLOP/s), bound "
                      f"{bms:.4f} ms ({by}), {ms / bms:.2f}x the bound; "
                      f"with F.group_norm {r[f'lib_{k}_{kind}']:.4f} ms")
        print(f"[kernels] vqgan fwd {name} bf16: device time by "
              f"torch.profiler {fmt_ms(r['prof_fwd_bf16'])} ms")
    persp, persp_err = None, {"fwd": 0.0, "bwd": 0.0}
    for kind, h, w, dtype, timed in (
            ("persp-main", 224, 224, torch.bfloat16, True),
            ("persp", 224, 224, torch.bfloat16, False),
            ("persp", 224, 224, torch.float32, False),
            ("rotate", 224, 224, torch.bfloat16, True),
            ("rotate", 224, 224, torch.float32, False),
            ("corners", 224, 224, torch.bfloat16, False),
            ("corners", 224, 224, torch.float32, False),
            ("persp", 200, 216, torch.bfloat16, False),
            ("persp", 200, 216, torch.float32, False),
            ("persp", 33, 97, torch.bfloat16, False),
            ("persp", 33, 97, torch.float32, False)):
        r = check_persp(kind, 200, h, w, dtype, timed=timed)
        print(f"[kernels] persp {kind} {h}x{w} {str(dtype)[6:]} "
              f"({r['flagged']} of 200 flagged): fwd max|err| "
              f"{r['fwd_err']:.3g} (|ref| {r['fwd_scale']:.3g}), grad max|err| "
              f"{r['grad_err']:.3g} (|ref| {r['grad_scale']:.3g}), tol "
              f"{r['tol_rel']:.3g} rel; the backward repeats bit for bit"
              + (" (two launches, a graph replay)" if timed else ""))
        persp_err["fwd"] = max(persp_err["fwd"], r["fwd_err"])
        persp_err["bwd"] = max(persp_err["bwd"], r["grad_err"])
        if not timed:
            continue
        for k in ("fwd", "bwd"):
            print(f"[kernels] persp {k} {kind} [200,3,{h},{w}] bf16: kernel "
                  f"{r['ms_' + k]:.4f} ms (graph replay "
                  f"{r['graph_' + k]:.4f}), plain {r['plain_' + k]:.4f} ms, "
                  f"grid_sample {r['lib_' + k]:.4f} ms (|err| vs kernel "
                  f"{r['lib_err']:.3g}), bound {r['bound_' + k][0]:.4f} ms "
                  f"({r['bound_' + k][1]})")
        persp = persp or r
    shift = None
    for rows, n_in, n, off, win, timed in (
            (134400, 224, 224, 0, (0, 224), True),
            (96, 16, 24, 4, (0, 24), False),
            (96, 24, 24, 0, (4, 16), False),
            (40, 12, 12, 0, (0, 12), False),
            (1000, 20, 26, 3, (3, 17), False),
            (300, 250, 250, 0, (0, 250), False),
            (200, 336, 336, 0, (0, 336), False)):
        r = check_shift(rows, n_in, n, off, win, timed=timed)
        print(f"[kernels] frac_shift [{rows},{n_in}] n={n} in_offset={off} "
              f"out_window={win}: fwd max|err| {r['fwd_err']:.3g} (|ref| "
              f"{r['fwd_scale']:.3g}), grad max|err| {r['grad_err']:.3g} "
              f"(|ref| {r['grad_scale']:.3g}), tol {r['tol_rel']:.3g} rel")
        if timed:
            shift = r
            print(f"[kernels] frac_shift [{rows},{n_in}] float32: kernel "
                  f"{r['ms']:.4f} ms (graph replay {r['graph']:.4f}), plain "
                  f"{r['plain']:.4f} ms, rfft/irfft route {r['fft']:.4f} ms, bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, 3xTF32; float32 "
                  f"FMAs {r['bound_f32'][0]:.4f} ms)")
    wcut, win_err = None, 0.0
    for kind, dtype, timed in (("main", torch.bfloat16, True),
                               ("main", torch.float32, False),
                               ("narrow", torch.bfloat16, False),
                               ("narrow", torch.float32, False),
                               ("edge", torch.bfloat16, False),
                               ("edge", torch.float32, False),
                               ("m336", torch.bfloat16, False),
                               ("m288", torch.bfloat16, True)):
        r = check_win_cutout(kind, dtype, timed=timed)
        print(f"[kernels] win_cut_fwd {kind} {str(dtype)[6:]} (tiers "
              f"{r['tiers']}): max|err| {r['fwd_err']:.3g} (|ref| "
              f"{r['fwd_scale']:.3g}), tol {r['tol_rel']:.3g} rel")
        win_err = max(win_err, r["fwd_err"])
        if timed:
            wcut = wcut or r
            print(f"[kernels] win_cut_fwd S={r['s']} M={r['m']} 720x1280 bf16 "
                  f"({r['gflop']:.1f} GFLOP): kernel {r['ms']:.4f} ms "
                  f"(graph replay {r['graph']:.4f}), plain {r['plain']:.4f} "
                  f"ms, dense einsum {r['lib']:.4f} ms (graph replay "
                  f"{r['graph_lib']:.4f}), bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}); {r['gflop'] / r['graph']:.1f} "
                  f"TFLOP/s by graph replay; a captured windowed cut "
                  f"replays bit for bit")
    lnr, ln_err = None, {"fwd": 0.0, "bwd": 0.0}
    for rows, d, dtype, timed in ((9500, 768, torch.bfloat16, True),
                                  (1799, 1024, torch.bfloat16, True),
                                  (9500, 768, torch.float32, False),
                                  (1201, 256, torch.float32, False),
                                  (1201, 256, torch.bfloat16, False)):
        r = check_ln(rows, d, dtype, timed=timed)
        print(f"[kernels] ln [{rows},{d}] {str(dtype)[6:]}: " + ", ".join(
            f"{k} max|err| {e:.3g} (|ref| {sc:.3g})"
            for k, (e, sc) in r["errs"].items()))
        if timed:
            lnr = lnr or r
            for k, lib in (("fwd", "F.layer_norm"),
                           ("bwd", "native_layer_norm_backward")):
                print(f"[kernels] ln {k} [{rows},{d}] bf16: kernel "
                      f"{r['ms_' + k]:.4f} ms (graph replay "
                      f"{r['graph_' + k]:.4f}), plain {r['plain_' + k]:.4f} "
                      f"ms, {lib} {r['lib_' + k]:.4f} ms (graph replay "
                      f"{r['graph_lib_' + k]:.4f}), bound "
                      f"{r['bound_' + k][0]:.4f} ms ({r['bound_' + k][1]})")
            print(f"[kernels] ln fwd [{rows},{d}] bf16 host cost: "
                  f"{r['host_fwd']:.2f} us a call (F.layer_norm "
                  f"{r['host_lib_fwd']:.2f} us), 1000 calls, one sync")
        ln_err = {k: max(ln_err[k], r[k + "_err"]) for k in ln_err}
    blk, blk_err = None, {k: 0.0 for k in BLOCK_KERNELS}
    for rows, t, d, heads, dtype, timed in (
            (9500, 50, 768, 12, torch.bfloat16, True),
            (9500, 50, 768, 12, torch.float32, False),
            (91, 13, 40, 2, torch.bfloat16, False),
            (91, 13, 40, 2, torch.float32, False),
            (1037, 17, 128, 2, torch.bfloat16, False),
            (1037, 17, 128, 2, torch.float32, False),
            # two 64-key tiles: o and the row sums add up over both, rs
            # sums over both before any ds
            (16 * 72, 72, 768, 12, torch.bfloat16, False),
            (16 * 72, 72, 768, 12, torch.float32, False),
            (16 * 80, 80, 768, 12, torch.bfloat16, False),
            (16 * 80, 80, 768, 12, torch.float32, False)):
        r = check_block(rows, t, d, heads, dtype, timed=timed)
        print(f"[kernels] block [{rows},{d}] t={t} {heads} heads "
              f"{str(dtype)[6:]}: " + ", ".join(
                  f"{k[6:]} max|err| {e:.3g} (|ref| {sc:.3g})"
                  for k, (e, sc) in r["errs"].items())
              + f", tol {r['tol_rel']:.3g} rel")
        for k in BLOCK_KERNELS:
            blk_err[k] = max(blk_err[k], r["errs"][k][0])
        if timed:
            blk = r
            for k in BLOCK_KERNELS:
                q = r[k]
                print(f"[kernels] {k} [{rows},{d}] t={t} bf16 "
                      f"({q['gflop']:.1f} GFLOP): kernel {q['ms']:.4f} ms "
                      f"(graph replay {q['graph']:.4f}), "
                      f"plain {q['plain']:.4f} ms, unfused half "
                      f"{q['unfused']:.4f} ms, bound {q['bound'][0]:.4f} ms "
                      f"({q['bound'][1]})")
            for label, (ms, ys, yname, gf, e, sc) in r["fwd_launches"].items():
                times = ", ".join(
                    f"{w}-wide {v:.4f} ms ({gf / v:.1f} TFLOP/s)" if w
                    else f"{v:.4f} ms ({gf / v:.1f} TFLOP/s)"
                    for w, v in ms.items())
                print(f"[kernels] block fwd launch {label} [{rows},{d}] t={t} "
                      f"bf16 ({gf:.2f} GFLOP): graph replay {times}, {yname} "
                      f"{ys:.4f} ms; max|err| {e:.3g} (|ref| {sc:.3g})")
            for label, (ms, ys, yname, gf, e, sc) in r["launches"].items():
                print(f"[kernels] block bwd launch {label} [{rows},{d}] t={t} "
                      f"bf16 ({gf:.2f} GFLOP): graph replay {ms:.4f} ms "
                      f"({gf / ms:.1f} TFLOP/s), {yname} {ys:.4f} ms; "
                      f"max|err| {e:.3g} (|ref| {sc:.3g})")
    for k in BLOCK_KERNELS:
        src, rep = KERNELS[k]
        q = blk[k]
        # no single PyTorch call computes a half block: library_ms is null
        # and the unfused half's time is printed above
        report[k] = {
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": blk_err[k], "ms": q["ms"],
            "plain_ms": q["plain"], "bound_ms": q["bound"][0],
            "bound_by": q["bound"][1], "library_ms": None,
            "device_ms": q["graph"]}
    for name, r, k, err in (("ln_fwd", lnr, "fwd", ln_err["fwd"]),
                            ("ln_bwd", lnr, "bwd", ln_err["bwd"]),
                            ("attn_fwd", att, "fwd", att["fwd_err"]),
                            ("attn_bwd", att, "bwd", att["grad_err"]),
                            ("cutout_fwd", cut, "fwd", cut_err["fwd"]),
                            ("cutout_bwd", cut, "bwd", cut_err["bwd"]),
                            ("persp_fwd", persp, "fwd", persp_err["fwd"]),
                            ("persp_bwd", persp, "bwd", persp_err["bwd"])):
        src, rep = KERNELS[name]
        report[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": err, "ms": r["ms_" + k],
            "plain_ms": r["plain_" + k], "bound_ms": r["bound_" + k][0],
            "bound_by": r["bound_" + k][1], "library_ms": r["lib_" + k],
            "device_ms": r["graph_" + k]}
    src, rep = KERNELS["frac_shift"]
    report["frac_shift"] = {
        "name": "frac_shift", "route": "cuda", "source": src, "replaces": rep,
        "launches": 0, "max_abs_err": max(shift["fwd_err"], shift["grad_err"]),
        "ms": shift["ms"], "plain_ms": shift["plain"],
        "bound_ms": shift["bound"][0], "bound_by": shift["bound"][1],
        "library_ms": None, "device_ms": shift["graph"]}
    src, rep = KERNELS["win_cut_fwd"]
    report["win_cut_fwd"] = {
        "name": "win_cut_fwd", "route": "cuda", "source": src,
        "replaces": rep, "launches": 0, "max_abs_err": win_err,
        "ms": wcut["ms"], "plain_ms": wcut["plain"],
        "bound_ms": wcut["bound"][0], "bound_by": wcut["bound"][1],
        "library_ms": wcut["lib"], "device_ms": wcut["graph"]}


# ---------------------------------------------------------------- main path

def _run_cli(argv):
    from aphantasia_torch.cli import clip_fft
    return clip_fft.run(clip_fft.get_args(argv))


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
    for k in ("attn_fwd", "attn_bwd", "cutout_fwd",
              "cutout_bwd") + BLOCK_KERNELS:
        check(k == "attn_bwd" or launches.get(k, 0) > 0,
              f"main path never launched {k}")
        if k in report:
            report[k]["launches"] = launches.get(k, 0)
    # every step: 12 vision blocks as the fused halves forward and
    # backward, one cutout each way; before the loop: 12 text layers for
    # the one prompt
    expect = b32(steps, 12, cutout_fwd=steps, cutout_bwd=steps)
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
    print(f"[main] default (contraction kernel cut) run: launches "
          f"{launches2}")
    check(all(math.isfinite(x) for x in res2.losses),
          f"default path losses not finite: {res2.losses}")
    check(all(launches2.get(k, 0) > 0 for k in BLOCK_KERNELS),
          "default path never launched the fused block kernels")
    check(launches2.get("cutout_fwd", 0) == 0,
          "default path launched the cutout kernel")
    check(launches2 == b32(steps, 12, **dense_cut(steps)),
          f"default path: launches {launches2} != expected "
          f"{b32(steps, 12, **dense_cut(steps))}")
    steady2 = sorted(res2.step_seconds[1:] or res2.step_seconds)
    print(f"[main] default path: {steps} steps, first step "
          f"{res2.step_seconds[0]:.3f} s, steady "
          f"{1.0 / steady2[len(steady2) // 2]:.3f} steps/s on {name}; "
          f"losses {[round(x, 5) for x in res2.losses]}")

    # the augmentation paths of the perspective and shift kernels, each
    # with --pallas: every step launches the slice-1 kernels as above, and
    #   --persp mixed: one perspective warp forward and backward;
    #   --persp exact: two each (the perspective and the rotate stage);
    #   elastic + switch: two shift passes forward, two backward;
    #   elastic alone: the plain shift (no kernel).
    base = b32(steps, 12, cutout_fwd=steps, cutout_bwd=steps)
    for label, extra, env, more in (
            ("--persp mixed", ["--persp", "mixed"], None,
             {"persp_fwd": steps, "persp_bwd": steps}),
            ("--persp exact", ["--persp", "exact"], None,
             {"persp_fwd": 2 * steps, "persp_bwd": 2 * steps}),
            ("-tf elastic, APHANTASIA_PALLAS_SHIFT=1", ["-tf", "elastic"],
             {"APHANTASIA_PALLAS_SHIFT": "1"}, {"frac_shift": 4 * steps}),
            ("-tf elastic", ["-tf", "elastic"], None, {})):
        argv3 = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
                 "--samples", "200", "--steps", str(steps), "--pallas",
                 "--out_dir", os.path.join(OUT_DIR, "augs"), "-nv",
                 "--seed", "1"] + extra
        with env_set(env):
            kernels.reset_launches()
            res3 = _run_cli(argv3)
            torch.cuda.synchronize()
            got = dict(kernels.LAUNCHES)
        print(f"[main] {label} run: launches {got}")
        check(len(res3.losses) == steps
              and all(math.isfinite(x) for x in res3.losses),
              f"{label} losses not finite: {res3.losses}")
        check(tuple(res3.params.shape) == (1, 3, 720, 641, 2)
              and bool(torch.isfinite(res3.params).all()),
              f"{label}: bad final params")
        run_dir = os.path.join(OUT_DIR, "augs", res3.out_name)
        frames = [f for f in os.listdir(run_dir) if f.endswith(".jpg")]
        check(len(frames) == steps, f"{label}: {len(frames)} frames")
        want = dict(base, **more)
        check(got == want, f"{label}: launches {got} != expected {want}")
        for k in more:
            if k in report:
                report[k]["launches"] = got[k]
        steady3 = sorted(res3.step_seconds[1:] or res3.step_seconds)
        print(f"[main] {label}: {steps} steps, {res3.samples} cutouts, first "
              f"step {res3.step_seconds[0]:.3f} s, steady "
              f"{1.0 / steady3[len(steady3) // 2]:.3f} steps/s on {name}; "
              f"losses {[round(x, 5) for x in res3.losses]}")
    # a result holds its run's frame loop (graph pool, buffers, weights)
    del res, res2, res3
    torch.cuda.empty_cache()
    phase_main_switches(report, steps)
    phase_main_flags(steps)
    phase_main_336()
    phase_main_resnet(steps)
    phase_main_illustra(steps)
    phase_main_illustrip()
    phase_main_coord(steps)


_TMP: list = []


def tmp_dir() -> str:
    """The run's temporary directory (the sync image, the checkpoint),
    made at first use and removed when `main` ends."""
    if not _TMP:
        _TMP.append(tempfile.TemporaryDirectory(prefix="chip_smoke_"))
    return _TMP[0].name


def sync_image() -> str:
    """A 1280x720 RGB image for `--sync -i`, written once with numpy and
    PIL: smooth colour ramps under seeded noise, so that every VGG16 tap
    sees structure."""
    path = os.path.join(tmp_dir(), "sync.png")
    if not os.path.isfile(path):
        import numpy as np
        from PIL import Image
        yy, xx = np.mgrid[0:720, 0:1280].astype(np.float32)
        ramps = np.stack([xx / 1280.0, yy / 720.0,
                          0.5 + 0.5 * np.sin(xx / 40.0 + yy / 70.0)], -1)
        noise = np.random.RandomState(5).rand(720, 1280, 3)
        img = np.clip(0.8 * ramps + 0.2 * noise, 0.0, 1.0)
        Image.fromarray((img * 255).astype(np.uint8)).save(path)
    return path


def write_checkpoint(seed: int = 11):
    """A full-width ViT-B/32 checkpoint in the OpenAI key layout (random
    weights from a seed, fp16 as OpenAI's releases store them) in the
    run's temporary directory: (path, the tree it holds, read back as
    float32)."""
    import torch
    from aphantasia_torch.models.clip.convert import openai_state_dict
    from aphantasia_torch.models.clip.model import CLIP_CONFIGS, clip_init
    params = clip_init(torch.Generator().manual_seed(seed),
                       CLIP_CONFIGS["ViT-B/32"])
    sd = {k: v.half() for k, v in openai_state_dict(params).items()}
    path = os.path.join(tmp_dir(), "vit_b32_openai.pt")
    torch.save(sd, path)
    return path, params


def phase_main_flags(steps: int):
    """The `clip_fft` flags of the loss terms, towers and generators, each
    an 8-step `--pallas` run at full width (1280x720, 200 samples before
    the budget) with its exact launch counts:
      (f) --dualmod 4: ViT-B/32 and ViT-B/16 (step 4 on ViT-B/16), 43
          cutouts; both text towers encode the prompt;
      (g) --sync 0.4 -i (a 1280x720 image written here): LPIPS against
          its half-size copy, 95 cutouts; the image prompt is encoded once
          through the float32 tower;
      (h) --aest 1 --clip_weights (a full-width ViT-B/32 checkpoint in
          the OpenAI layout, written here and deleted at the end): the
          loaded tower equals the tree written, rounded to fp16;
      (i) --dwt: the coif2 pyramid of 9 levels, saved as a list.
    Every step launches one attention forward and backward a layer (12
    layers in both towers) and one cutout each way."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.models.clip.model import load_clip
    from aphantasia_torch.params.dwt import DWTParameterizer
    name = torch.cuda.get_device_name(0)
    ckpt, written = write_checkpoint()
    loaded, _ = load_clip("ViT-B/32", ckpt)
    for path in (("visual", "conv"), ("text", "text_projection"),
                 ("visual", "blocks", 11, "attn", "in_w")):
        a, b = loaded, written
        for k in path:
            a, b = a[k], b[k]
        check(torch.equal(a, b.half().float()),
              f"(h) the checkpoint's {path} did not load as written")
    from aphantasia_torch.cli.common import dualmod_steps
    cut = {"cutout_fwd": steps, "cutout_bwd": steps}
    base = b32(steps, 12, **cut)
    out = os.path.join(OUT_DIR, "flags")
    for label, extra, samples, want, suffix in (
            ("(f) --dualmod 4", ["--dualmod", "4"], 43,
             b32_dual(steps, len(dualmod_steps(steps, 4)), 24, **cut),
             "-dm4"),
            ("(g) --sync 0.4 -i", ["--sync", "0.4", "-i", sync_image()], 95,
             b32(steps, 24, **cut), "-sync-ViTB32"),
            ("(h) --aest 1 --clip_weights", ["--aest", "1", "--clip_weights",
                                             ckpt], 190, base, "-ViTB32"),
            ("(i) --dwt", ["--dwt", "--save_pt"], 190, base, "-ViTB32")):
        argv = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
                "--samples", "200", "--steps", str(steps), "--pallas",
                "--out_dir", out, "-nv", "--seed", "1"] + extra
        kernels.reset_launches()
        res = _run_cli(argv)
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        print(f"[main] {label} run: launches {got}")
        check(res.samples == samples, f"{label}: {res.samples} cutouts")
        check(res.out_name.endswith(suffix), f"{label}: {res.out_name}")
        check(len(res.losses) == steps
              and all(math.isfinite(x) for x in res.losses),
              f"{label} losses not finite: {res.losses}")
        params = res.params if isinstance(res.params, list) else [res.params]
        shapes = ([(1, 3, 720, 641, 2)] if "--dwt" not in extra else
                  DWTParameterizer((720, 1280), "coif2").shapes)
        check([tuple(p.shape) for p in params] == shapes
              and all(bool(torch.isfinite(p).all()) for p in params),
              f"{label}: bad final params")
        run_dir = os.path.join(out, res.out_name)
        frames = [f for f in os.listdir(run_dir) if f.endswith(".jpg")]
        check(len(frames) == steps, f"{label}: {len(frames)} frames")
        check(os.path.isfile(os.path.join(run_dir, "config.txt")),
              f"{label}: config.txt missing")
        check(got == want, f"{label}: launches {got} != expected {want}")
        if "--dwt" in extra:
            saved = torch.load(os.path.join(out, res.out_name + ".pt"))
            check([tuple(x.shape) for x in saved] == shapes,
                  "(i) the saved pyramid")
        steady = sorted(res.step_seconds[1:] or res.step_seconds)
        print(f"[main] {label}: {steps} steps, {res.samples} cutouts, first "
              f"step {res.step_seconds[0]:.3f} s, steady "
              f"{1.0 / steady[len(steady) // 2]:.3f} steps/s on {name}; "
              f"losses {[round(x, 5) for x in res.losses]}")
        del res
    os.remove(ckpt)


def phase_main_336(images: int = 4):
    """ViT-L/14@336px at tower level (its CLI, illustra, is a later slice):
    one bf16 forward and backward of the image tower at full width (24
    layers of width 1024, 16 heads, 577 tokens) on `images` random images,
    random weights from a seed.  Exactly one attention launch each way per
    layer, finite embeddings and image gradient."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.models.clip.model import (CLIP_CONFIGS, cast_weights,
                                                    clip_init, encode_image)
    name = "ViT-L/14@336px"
    cfg = CLIP_CONFIGS[name]
    g = torch.Generator(device="cuda").manual_seed(5)
    vis = {"visual": cast_weights(clip_init(g, cfg)["visual"],
                                  torch.bfloat16)}
    res = cfg.image_resolution
    x = torch.randn((images, 3, res, res), generator=g, device="cuda",
                    requires_grad=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    emb = encode_image(vis, cfg, x, torch.bfloat16)
    (gx,) = torch.autograd.grad(emb.float().square().sum(), x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(kernels.LAUNCHES)
    want = {"attn_fwd": cfg.vision_layers, "attn_bwd": cfg.vision_layers}
    print(f"[main] {name} tower, {images} images of {res} px "
          f"({(res // cfg.vision_patch_size) ** 2 + 1} tokens), bf16 forward "
          f"and backward: launches {got}, {wall:.3f} s (first call) on "
          f"{torch.cuda.get_device_name(0)}")
    check(got == want, f"{name} tower: launches {got} != expected {want}")
    check(tuple(emb.shape) == (images, cfg.embed_dim)
          and bool(torch.isfinite(emb.float()).all())
          and bool(torch.isfinite(gx).all()) and gx.abs().max().item() > 0,
          f"{name} tower: embeddings or image gradient not finite")
    del vis, emb, gx
    torch.cuda.empty_cache()


# (label, model, cutouts after the budget): clip_fft's ModifiedResNets
RESNET_PATHS = (("(j)", "RN50", 95), ("(k)", "RN101", 62),
                ("(l)", "RN50x4", 30), ("(m)", "RN50x16", 11))


def _steady_sps(secs) -> float:
    """Steps/s: the median of the step seconds after the first."""
    steady = sorted(secs[1:] or secs)
    return 1.0 / steady[len(steady) // 2]


def _graph_step_ms(loop) -> float:
    """Device ms a step of a one-pattern frame loop: CUDA events around 10
    back-to-back replays of its graph, over the group's steps."""
    (group,) = loop.groups.values()
    return cuda_ms(group.graph.graph.replay, iters=10,
                   warmup=2) / loop.opt_step


def phase_main_resnet(steps: int):
    """(j)-(m): `clip_fft -m RN50|RN101|RN50x4|RN50x16 --pallas` at full
    width, 8 steps each (random weights from a seed; 95, 62, 30 and 11
    cutouts of 224, 224, 288 and 384 px).  Launches: the text tower's 12
    attention forwards once (one prompt), one cutout each way a step; the
    ResNet tower runs no kernel of the port (cuDNN convolutions, its pool a
    plain softmax)."""
    import torch
    from aphantasia_torch import kernels
    name = torch.cuda.get_device_name(0)
    for label, model, samples in RESNET_PATHS:
        argv = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
                "--samples", "200", "--steps", str(steps), "--pallas",
                "-m", model, "--out_dir", os.path.join(OUT_DIR, "resnet"),
                "-nv", "--seed", "1"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = _run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
        want = {"attn_fwd": 12, "cutout_fwd": steps, "cutout_bwd": steps}
        print(f"[main] {label} -m {model} --pallas run: launches {got}")
        check(res.samples == samples, f"{label}: {res.samples} cutouts")
        check(len(res.losses) == steps
              and all(math.isfinite(x) for x in res.losses),
              f"{label} losses not finite: {res.losses}")
        check(tuple(res.params.shape) == (1, 3, 720, 641, 2)
              and bool(torch.isfinite(res.params).all()),
              f"{label}: bad final params")
        run_dir = os.path.join(OUT_DIR, "resnet", res.out_name)
        frames = [f for f in os.listdir(run_dir) if f.endswith(".jpg")]
        check(len(frames) == steps, f"{label}: {len(frames)} frames")
        check(got == want, f"{label}: launches {got} != expected {want}")
        peak = torch.cuda.max_memory_allocated()
        sps = _steady_sps(res.step_seconds)
        ms = _graph_step_ms(res.loop)
        print(f"[main] {label} -m {model} --pallas: {steps} steps, "
              f"{res.samples} cutouts, first step {res.step_seconds[0]:.3f} s, "
              f"steady {sps:.3f} steps/s, device ms a step by replay "
              f"{ms:.3f}, busy share {ms * sps / 1000:.3f}, peak memory "
              f"{peak / 2**20:.0f} MiB, wall {wall:.1f} s on {name}; losses "
              f"{[round(x, 5) for x in res.losses]}")
        del res
        torch.cuda.empty_cache()


SCENES = ("a lighthouse on a cliff at dawn\n"
          "# the scenes' comment line\n"
          "the same lighthouse in a storm\n"
          "a calm sea at night\n")


def scenes_file(n: int = 3) -> str:
    """A text file of `n` scenes (of SCENES) and a comment line."""
    path = os.path.join(tmp_dir(), f"scenes{n}.txt")
    lines = SCENES.splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:n + 1]) + "\n")
    return path


def _run_illustra(label, argv, want, scenes: int, lsteps: int, samples: int):
    """One `illustra` run with its checks: the launch counts, the cutouts,
    each scene's frames, last frame, mp4 and `.pt`, the crossfade's
    frames, one frame loop whose one graph every scene replayed; prints
    steps/s, peak memory and wall.  Returns the run's out_dir."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import illustra
    out = os.path.join(OUT_DIR, argv[argv.index("--out_dir") + 1])
    argv = list(argv)
    argv[argv.index("--out_dir") + 1] = out
    a = illustra.get_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = illustra.run(a)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(kernels.LAUNCHES)
    print(f"[main] {label} run: launches {got}")
    check(res.samples == samples, f"{label}: {res.samples} cutouts")
    check(len(res.out_names) == scenes, f"{label}: scenes {res.out_names}")
    for n, losses in zip(res.out_names, res.losses):
        frames = [f for f in os.listdir(os.path.join(out, n))
                  if f.endswith(".jpg")]
        check(len(frames) == a.steps and len(losses) == a.steps
              and all(math.isfinite(x) for x in losses),
              f"{label} {n}: {len(frames)} frames, losses {losses}")
        for ext in (".mp4", ".pt", f"-{a.steps}.jpg"):
            check(os.path.isfile(os.path.join(out, n + ext)),
                  f"{label}: {n}{ext} missing")
    pts = [f for f in os.listdir(out) if f.endswith(".pt")]
    finals = [f for f in os.listdir(os.path.join(out, "_final"))
              if f.endswith(".jpg")]
    check(len(pts) == scenes and len(finals) == scenes * lsteps
          and res.final_frames == scenes * lsteps and res.video is not None,
          f"{label}: {len(pts)} snapshots, {len(finals)} crossfade frames, "
          f"video {res.video}")
    check(tuple(res.params.shape) == (1, 3, 720, 641, 2)
          and bool(torch.isfinite(res.params).all()), f"{label}: bad params")
    loops = res.scene_loop.loops
    groups = [g for lp in loops.values() for g in lp.groups.values()]
    check(len(loops) == 1 and len(groups) == 1
          and groups[0].graph is not None,
          f"{label}: {len(loops)} frame loops, {len(groups)} groups")
    check(got == want, f"{label}: launches {got} != expected {want}")
    secs = [x for sc in res.step_seconds for x in sc]
    peak = torch.cuda.max_memory_allocated()
    sps = _steady_sps(secs)
    ms = _graph_step_ms(next(iter(loops.values())))
    print(f"[main] {label}: {scenes} scenes of {a.steps} steps, {res.samples} "
          f"cutouts, first step {secs[0]:.3f} s, steady {sps:.3f} steps/s "
          f"(the later scenes replay the first scene's graph), device ms a "
          f"step by replay {ms:.3f}, busy share {ms * sps / 1000:.3f}, "
          f"{res.final_frames} crossfade frames, peak memory "
          f"{peak / 2**20:.0f} MiB, wall {wall:.1f} s on "
          f"{torch.cuda.get_device_name(0)}")
    del res
    torch.cuda.empty_cache()
    return out


def phase_main_illustra(steps: int):
    """(n) `illustra --pallas` (ViT-B/32, 190 cutouts, the default --aest 1
    head) over three scenes from a text file written here, `steps` steps
    each, then the crossfade at the default --lsteps 25 (75 frames);
    (o) `illustra -m RN50x64 --pallas`, two scenes of 4 steps: one cutout
    of 448 px through the whole RN50x64 tower, its text tower 1024 wide;
    (p) `interpol` on (n)'s snapshots (75 frames, no kernel);
    (q) `illustra -m ViT-L/14@336px --pallas --samples 40` (38 cutouts of
    577 tokens), one scene of 4 steps;
    (r) one eager step of ViT-L/14@336px at illustra's default budget (190
    cutouts, `--steps 1 --save_step 2`: the per-step loop): its peak
    memory, or the out-of-memory error it meets (reported, not a
    failure)."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import illustra, interpol
    base = ["--size", "1280-720", "--samples", "200", "--pallas", "-nv",
            "--seed", "1"]
    n_out = _run_illustra(
        "(n) illustra --pallas, 3 scenes",
        ["-t", scenes_file(3), "--steps", str(steps), "--out_dir",
         "illustra"] + base,
        b32(3 * steps, 36, cutout_fwd=3 * steps, cutout_bwd=3 * steps), 3,
        25, 190)
    _run_illustra(
        "(o) illustra -m RN50x64 --pallas, 2 scenes",
        ["-t", scenes_file(2), "-m", "RN50x64", "--steps", "4", "--out_dir",
         "illustra64"] + base,
        {"attn_fwd": 24, "cutout_fwd": 8, "cutout_bwd": 8}, 2, 25, 1)
    kernels.reset_launches()
    t0 = time.perf_counter()
    video = interpol.main(["-i", n_out, "-o", os.path.join(OUT_DIR, "pts"),
                           "-s", "25", "-v", ""])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames = [f for f in os.listdir(os.path.join(OUT_DIR, "pts", "a"))
              if f.endswith(".jpg")]
    check(len(frames) == 75 and video is not None
          and not any(kernels.LAUNCHES.values()),
          f"(p) interpol: {len(frames)} frames, video {video}, launches "
          f"{dict(kernels.LAUNCHES)}")
    print(f"[main] (p) interpol on (n)'s 3 snapshots: {len(frames)} frames "
          f"at 1280x720, no kernel launched, wall {wall:.1f} s")
    _run_illustra(
        "(q) illustra -m ViT-L/14@336px --pallas --samples 40",
        ["-t", "a lighthouse on a cliff at dawn", "-m", "ViT-L/14@336px",
         "--steps", "4", "--lsteps", "2", "--out_dir", "illustra336"]
        + base[:3] + ["40"] + base[4:],
        {"attn_fwd": 12 + 24 * 4, "attn_bwd": 24 * 4, "cutout_fwd": 4,
         "cutout_bwd": 4}, 1, 2, 38)
    a = illustra.get_args(["-t", "a lighthouse on a cliff at dawn", "-m",
                           "ViT-L/14@336px", "--steps", "1", "--save_step",
                           "2", "--lsteps", "1", "--out_dir",
                           os.path.join(OUT_DIR, "illustra336d")] + base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = illustra.run(a)
        check(not res.scene_loop.chunked and len(res.losses[0]) == 1
              and math.isfinite(res.losses[0][0]), "(r): the eager step")
        outcome = (f"one eager step, peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        del res
    except torch.OutOfMemoryError as e:
        outcome = (f"out of memory after a peak of "
                   f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB "
                   f"({str(e).splitlines()[0][:160]})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[main] (r) ViT-L/14@336px at illustra's default budget "
          f"({a.samples} cutouts of 577 tokens): {outcome}; wall "
          f"{time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**20:.0f} "
          f"MiB on the card")


# ---------------------------------------------------------------- illustrip

TRIP_SCENES = ("a lighthouse on a cliff at dawn\n"
               "the same lighthouse in a storm\n")


def trip_file() -> str:
    """The two scenes of the illustrip paths, one prompt part each."""
    path = os.path.join(tmp_dir(), "trip.txt")
    with open(path, "w") as f:
        f.write(TRIP_SCENES)
    return path


def depth_images() -> str:
    """Three images of two sizes (two 1280x720, one 640x480) for the
    `depth` CLI: smooth colour ramps under seeded noise."""
    import numpy as np
    from PIL import Image
    d = os.path.join(tmp_dir(), "depth_in")
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(5)
    for name, (h, w) in (("a", (720, 1280)), ("b", (480, 640)),
                         ("c", (720, 1280))):
        yy, xx = np.mgrid[0:h, 0:w]
        ramp = np.stack([xx / w, yy / h, (xx + yy) / (h + w)], -1)
        img = np.clip(ramp + 0.1 * rs.randn(h, w, 3), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(d, f"{name}.png"))
    return d


def _trip_stats(res, a, dual=None):
    """(first frame s, steady frames/min, device ms a frame by graph
    replay, busy share) of an illustrip run: steady is every frame after
    the last that ran a group's eager first run and capture, up to the
    run's end after a synchronise; a frame's device ms is its group's
    graph replayed (10 back to back, CUDA events), with the second
    tower's graph on its frames (`dual`) and the DA-V2 graph once a frame
    with depth."""
    from aphantasia_torch.cli.common import dualmod_steps
    k = max(res.first_frames) + 1
    check(k < res.frames, f"illustrip: no steady frames ({res.first_frames})")
    fpm = (res.frames - k) / (res.end - res.starts[k]) * 60.0
    ms = [cuda_ms(next(iter(fs.groups.values())).graph.graph.replay,
                  iters=10, warmup=2) for fs in res.frame_steps]
    if dual is None:
        frame_ms = ms[0]
    else:
        n2 = len(dualmod_steps(a.steps, dual))
        frame_ms = (ms[0] * (a.steps - n2) + ms[1] * n2) / a.steps
    dav2_ms = None
    if res.depth is not None:
        dav2_ms = cuda_ms(res.depth.infer.graph.graph.replay, iters=10,
                          warmup=2)
        frame_ms += dav2_ms
    return (res.starts[1] - res.starts[0], fpm, frame_ms,
            frame_ms * fpm / 60000.0, ms, dav2_ms)


def _run_illustrip(label, argv, want, frames: int, samples: int,
                   dual=None, depth_dir=None):
    """One `illustrip` run at full width with its checks: the launch
    counts, the cutouts, `frames` frames in ttt/ and the video, finite
    losses and state, one captured group a tower (each frame step replays
    it) and, with depth, the DA-V2 graph and a depth map a frame in
    `depth_dir`; prints frames/min (the first frame apart), device ms a
    frame by replay, busy share, peak memory and wall."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import illustrip
    out = os.path.join(OUT_DIR, "trip", label[1])    # a directory a path
    a = illustrip.get_args(argv + ["--out_dir", out, "-nv", "--seed", "1"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = illustrip.run(a)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] {label} run: launches {got}")
    check(res.samples == samples, f"{label}: {res.samples} cutouts")
    ttt = [f for f in os.listdir(os.path.join(res.workdir, "ttt"))
           if f.endswith(".jpg")]
    check(res.frames == frames and len(ttt) == frames
          and len(res.losses) == frames
          and all(math.isfinite(x) for ls in res.losses for x in ls),
          f"{label}: {res.frames} frames, {len(ttt)} files, losses "
          f"{res.losses[:3]}")
    check(res.video is not None and os.path.getsize(res.video) > 0
          and os.path.isfile(os.path.join(res.workdir, "config.txt")),
          f"{label}: video {res.video}")
    check(bool(torch.isfinite(res.params).all()), f"{label}: params")
    check(all(len(fs.groups) == 1 and next(iter(fs.groups.values())).graph
              is not None for fs in res.frame_steps),
          f"{label}: groups {[len(fs.groups) for fs in res.frame_steps]}")
    if depth_dir is not None:
        maps = [f for f in os.listdir(depth_dir) if f.endswith(".jpg")]
        check(len(maps) == frames and res.depth.infer.graph is not None,
              f"{label}: {len(maps)} depth maps")
    check(got == want, f"{label}: launches {got} != expected {want}")
    first, fpm, frame_ms, busy, ms, dav2_ms = _trip_stats(res, a, dual)
    losses = [round(x, 5) for x in res.losses[-1]]
    k = max(res.first_frames) + 1
    host = [sorted(x[j] for x in res.host[k:])[(len(res.host) - k) // 2]
            * 1e3 for j in range(3)]
    print(f"[main] {label}: {frames} frames at 1280x720, {res.samples} "
          f"cutouts, opt_step {a.opt_step}, first frame {first:.3f} s, "
          f"steady {fpm:.3f} frames/min (after frame "
          f"{max(res.first_frames)}), device ms a frame by replay "
          f"{frame_ms:.3f} (graphs {[round(x, 3) for x in ms]}"
          + ("" if dav2_ms is None else f", DA-V2 {dav2_ms:.3f}")
          + f"), busy share {busy:.3f}, host ms a steady frame (median) "
          f"prompts and draws {host[0]:.3f}, dispatch {host[1]:.3f}, writer "
          f"admit {host[2]:.3f}, peak memory {peak / 2**20:.0f} MiB, "
          f"wall {wall:.1f} s on {torch.cuda.get_device_name(0)}; last "
          f"losses {losses}")
    del res
    torch.cuda.empty_cache()


def phase_main_illustrip():
    """(s)-(w) `illustrip` at full width (ViT-B/32, random weights from a
    seed, 1280x720, 100 samples before the budget) and (x) `depth`:
    (s) the default video workload, `--gen RGB`, two scenes of 24 frames,
    `--fstep 12`; (t) `bench_illustrip.py`'s configuration, `--gen FFT
    --opt_step 3 -tf fast`, 24 frames; (u) (s) with `--pallas`; (v) (t)
    with `--depth 1` (DA-V2 `b`) and `--depth_dir`, 16 frames; (w) `--gen
    FFT --smooth --dualmod 2`, 24 frames; (x) `python -m
    aphantasia_torch.cli.depth` on three images of two sizes.  Launches:
    12 text-tower forwards a scene line and tower, 12 of each fused
    half-block entry point a ViT-B/32 train step (12 + 12 attention
    launches a ViT-B/16 one, on the flat stream), one cutout each way a
    step under `--pallas`; DINOv2 and the DPT head launch no kernel of the
    port."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import depth
    base = ["--size", "1280-720", "--samples", "100"]
    rgb = ["-t", trip_file(), "--steps", "24", "--fstep", "12"] + base
    fft = (["-t", "benchmark scene", "--steps", "24", "--fstep", "24",
            "--opt_step", "3", "--gen", "FFT", "-tf", "fast"] + base)
    _run_illustrip("(s) illustrip --gen RGB, 2 scenes", rgb,
                   b32(48, 24, **dense_cut(48)), 48, 95)
    _run_illustrip("(t) illustrip --gen FFT --opt_step 3", fft,
                   b32(72, 12, **dense_cut(72)), 24, 95)
    _run_illustrip("(u) illustrip --gen RGB --pallas, 2 scenes",
                   rgb + ["--pallas"],
                   b32(48, 24, cutout_fwd=48, cutout_bwd=48), 48, 95)
    ddir = os.path.join(tmp_dir(), "depth_maps")
    dfft = list(fft)
    dfft[dfft.index("--steps") + 1] = dfft[dfft.index("--fstep") + 1] = "16"
    _run_illustrip("(v) illustrip --gen FFT --opt_step 3 --depth 1",
                   dfft + ["--depth", "1", "--depth_dir", ddir],
                   b32(48, 12, **dense_cut(48)), 16, 95, depth_dir=ddir)
    _run_illustrip("(w) illustrip --gen FFT --smooth --dualmod 2",
                   ["-t", "benchmark scene", "--steps", "24", "--gen", "FFT",
                    "--smooth", "--dualmod", "2"] + base,
                   b32_dual(24, 11, 24, **dense_cut(24)), 24, 21, dual=2)
    src = depth_images()
    out = os.path.join(OUT_DIR, "depth")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    n = depth.main(["-i", src, "-o", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from PIL import Image
    import numpy as np
    sizes = []
    for name in ("a", "b", "c"):
        with Image.open(os.path.join(out, f"{name}.png")) as im:
            arr = np.asarray(im)
        sizes.append(arr.shape)
        check(arr.std() > 0, f"(x) depth: {name}.png is flat")
    check(n == 3 and sizes == [(720, 1280, 3), (480, 640, 3), (720, 1280, 3)]
          and not any(kernels.LAUNCHES.values()),
          f"(x) depth: {n} maps, sizes {sizes}, launches "
          f"{dict(kernels.LAUNCHES)}")
    print(f"[main] (x) depth on 3 images of two sizes (DA-V2 b, float32, "
          f"short side 768): {n} maps, no kernel of the port launched, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
          f"wall {wall:.1f} s with set-up on "
          f"{torch.cuda.get_device_name(0)}")


def taming_state_dict(params) -> dict:
    """A decoder tree (`vqgan_init`'s) in taming-transformers' key layout
    (OIHW, `decoder.*` and `post_quant_conv.*`), the inverse of
    `convert_taming`."""
    sd = {}

    def put(prefix, p):
        for k, v in p.items():
            sd[f"{prefix}.{'weight' if k in ('w', 'g') else 'bias'}"] = v

    def res(prefix, p):
        for k, name in (("norm1", "norm1"), ("conv1", "conv1"),
                        ("norm2", "norm2"), ("conv2", "conv2"),
                        ("nin", "nin_shortcut")):
            if k in p:
                put(f"{prefix}.{name}", p[k])

    def attn(prefix, p):
        for k, name in (("norm", "norm"), ("q", "q"), ("k", "k"),
                        ("v", "v"), ("proj", "proj_out")):
            put(f"{prefix}.{name}", p[k])

    put("post_quant_conv", params["post_quant"])
    put("decoder.conv_in", params["conv_in"])
    res("decoder.mid.block_1", params["mid"]["block1"])
    attn("decoder.mid.attn_1", params["mid"]["attn"])
    res("decoder.mid.block_2", params["mid"]["block2"])
    for level, lev in enumerate(params["up"]):
        for j, blk in enumerate(lev["blocks"]):
            res(f"decoder.up.{level}.block.{j}", blk)
        for j, att in enumerate(lev.get("attns", [])):
            attn(f"decoder.up.{level}.attn.{j}", att)
        if "upsample" in lev:
            put(f"decoder.up.{level}.upsample.conv", lev["upsample"])
    put("decoder.norm_out", params["norm_out"])
    put("decoder.conv_out", params["conv_out"])
    return sd


def _run_main(label, cli, argv, want, samples):
    """One run of a CLI module's `run` with its launch counts (exactly
    `want`), cutouts, finite losses, steps/s (the median step after the
    first), device ms a step by replay of the run's one graph, busy share,
    peak memory and wall; returns the result."""
    import torch
    from aphantasia_torch import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = cli.run(cli.get_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] {label} run: launches {got}")
    check(res.samples == samples, f"{label}: {res.samples} cutouts")
    check(all(math.isfinite(x) for x in res.losses),
          f"{label}: losses not finite: {res.losses}")
    check(got == want, f"{label}: launches {got} != expected {want}")
    sps = _steady_sps(res.step_seconds)
    ms = _graph_step_ms(res.loop)
    print(f"[main] {label}: {len(res.losses)} steps, {res.samples} cutouts, "
          f"first group {res.step_seconds[0] * res.loop.opt_step:.3f} s, "
          f"steady {sps:.3f} steps/s, device ms a step by replay {ms:.3f}, "
          f"busy share {ms * sps / 1000:.3f}, peak memory "
          f"{peak / 2**20:.0f} MiB, wall {wall:.1f} s with set-up on "
          f"{torch.cuda.get_device_name(0)}; losses "
          f"{[round(x, 5) for x in res.losses]}")
    return res


def phase_main_coord(steps: int):
    """(y)-(ac): `cppn` and `clip_vqgan` at full width, `steps` steps each
    (ViT-B/32, random weights from a seed).  (y) cppn as configured by
    default: 512x512, 50 cutouts, overscan, no transform, a 10-layer CPPN
    of width 24 (unbias), Adam at 0.003, --fstep 1 (a frame and a `.npy`
    snapshot every step); (z) `--gen siren` (5 layers of 256); (aa)
    `--pallas -tf --fstep 2` (47 cutouts, the snapshot at each group's
    render point); (ab) clip_vqgan with the imagenet_f16_16384 decoder
    from a full-width taming state dict written here from random weights
    and deleted, 640x480, 190 cutouts, uniform, fast, adam_custom at 0.1,
    sim mix; (ac) `--vqgan gumbel_f8_8192 -s 640-512 --pallas` (random
    decoder, 190 cutouts).  Launches: 12 text-tower forwards once, 12 of
    each fused half-block entry point a step, one cutout each way a step
    under --pallas; the CPPN, SIREN and VQGAN decodes launch no kernel of
    the port."""
    import torch
    from aphantasia_torch.cli import clip_vqgan, cppn
    from aphantasia_torch.models import vqgan as V
    text = ["-t", "a lighthouse on a cliff at dawn", "--steps", str(steps),
            "--seed", "1"]
    attn = b32(steps, 12, **dense_cut(steps))
    cut = b32(steps, 12, cutout_fwd=steps, cutout_bwd=steps)
    for label, extra, want, samples, fstep in (
            ("(y) cppn", [], attn, 50, 1),
            ("(z) cppn --gen siren", ["--gen", "siren"], attn, 50, 1),
            ("(aa) cppn --pallas -tf --fstep 2",
             ["--pallas", "-tf", "--fstep", "2"], cut, 47, 2)):
        out = os.path.join(OUT_DIR, "cppn", label[1:label.index(")")])
        res = _run_main(label, cppn, text + ["--out_dir", out] + extra, want,
                        samples)
        n = steps // fstep
        base = res.out_base
        files = sorted(os.listdir(base))
        check(files == sorted("%04d.%s" % (i, e) for i in range(n)
                              for e in ("jpg", "npy")),
              f"{label}: frame directory {files}")
        name = os.path.basename(base)
        beside = set(os.listdir(os.path.dirname(base)))
        need = {name + x for x in (".npy", "-td.glsl", ".tfx", ".txt",
                                   "-bookofshaders.glsl", "-shadertoy.glsl",
                                   f"-{steps}.jpg")}
        check(need <= beside and res.video is not None
              and os.path.getsize(res.video) > 0,
              f"{label}: {sorted(beside)}, video {res.video}")
        check(all(bool(torch.isfinite(p).all()) for p in res.params),
              f"{label}: params not finite")
        del res
        torch.cuda.empty_cache()
    cfg = V.VQGAN_CONFIGS["imagenet_f16_16384"]
    params = V.vqgan_init(torch.Generator().manual_seed(12), cfg)
    ckpt = os.path.join(tmp_dir(), "vqgan_f16.pt")
    torch.save(taming_state_dict(params), ckpt)
    for label, extra, want in (
            ("(ab) clip_vqgan imagenet_f16_16384 --vqgan_weights",
             ["--vqgan_weights", ckpt], attn),
            ("(ac) clip_vqgan --vqgan gumbel_f8_8192 -s 640-512 --pallas",
             ["--vqgan", "gumbel_f8_8192", "-s", "640-512", "--pallas"],
             cut)):
        out = os.path.join(OUT_DIR, "vqgan", label[1:label.index(")")])
        res = _run_main(label, clip_vqgan,
                        text + ["--out_dir", out, "-nv"] + extra, want, 190)
        run_dir = os.path.join(out, res.out_name)
        frames = [f for f in os.listdir(run_dir) if f.endswith(".jpg")]
        check(len(frames) == steps
              and os.path.isfile(os.path.join(run_dir, "config.txt"))
              and res.video is not None and os.path.getsize(res.video) > 0,
              f"{label}: {len(frames)} frames, video {res.video}")
        h, w = (480, 640) if "f16" in label else (512, 640)
        f = res.par.cfg.f
        check(tuple(res.params.shape) == (1, 256, h // f, w // f)
              and bool(torch.isfinite(res.params).all()),
              f"{label}: latent {tuple(res.params.shape)}")
        if "--vqgan_weights" in extra:
            check(torch.equal(res.par.decoder_params["up"][4]["attns"][2]
                              ["proj"]["w"].cpu(),
                              params["up"][4]["attns"][2]["proj"]["w"]),
                  f"{label}: the checkpoint did not load as written")
        del res
        torch.cuda.empty_cache()
    os.remove(ckpt)


def phase_main_switches(report, steps: int):
    """The switches' paths at full width without --pallas (the windowed
    forward replaces the dense one only there), each with its exact launch
    counts:
      (a) ViT-B/32 with the cutout and LayerNorm switches: one windowed cut
          a step; the vision blocks take the fused halves by default, whose
          LayerNorms are inside them, so no fused LayerNorm (as (e));
      (b) ViT-L/14 with both: 7 cutouts of 257 tokens (1799 rows), 24
          blocks, so 48 fused LayerNorms each way;
      (c) ViT-L/14 without them: no windowed cut, no fused LayerNorm;
      (d) ViT-B/32 with APHANTASIA_FUSED_BLOCK=1: each vision block as the
          two fused halves each way, so no vision attention kernel (the
          default route on the card);
      (e) ViT-B/32 with all three switches: as (d) plus the windowed cut;
          no fused LayerNorm, since the blocks' LayerNorms are inside the
          halves, ln_pre is 3-D and ln_post has 190 rows.
    The text tower (12 layers, [1, 77, D]) runs the attention kernel
    forward before the loop and no fused LayerNorm (3-D input)."""
    import torch
    from aphantasia_torch import kernels
    name = torch.cuda.get_device_name(0)
    text = {"attn_fwd": 12}   # the text tower's forward, once a run
    halves = {k: 12 * steps for k in BLOCK_KERNELS}

    def unfused(layers, switches):
        want = {"attn_fwd": layers * steps + 12, "attn_bwd": layers * steps}
        if switches:
            want.update(win_cut_fwd=steps, ln_fwd=2 * layers * steps,
                        ln_bwd=2 * layers * steps)
        return want
    for label, model, env, samples, want in (
            ("(a) ViT-B/32, both switches", "ViT-B/32", SWITCHES, 190,
             dict(text, win_cut_fwd=steps, **halves)),
            ("(b) ViT-L/14, both switches", "ViT-L/14", SWITCHES, 7,
             unfused(24, True)),
            ("(c) ViT-L/14", "ViT-L/14", None, 7,
             dict(unfused(24, False), **dense_cut(steps))),
            ("(d) ViT-B/32, fused block", "ViT-B/32", FUSED, 190,
             dict(text, **halves, **dense_cut(steps))),
            ("(e) ViT-B/32, all three switches", "ViT-B/32",
             dict(SWITCHES, **FUSED), 190,
             dict(text, win_cut_fwd=steps, **halves))):
        argv = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
                "--samples", "200", "--steps", str(steps), "-m", model,
                "--out_dir", os.path.join(OUT_DIR, "switches"), "-nv",
                "--seed", "1"]
        with env_set(env):
            kernels.reset_launches()
            res = _run_cli(argv)
            torch.cuda.synchronize()
            got = dict(kernels.LAUNCHES)
        print(f"[main] {label} run: launches {got}")
        check(res.samples == samples, f"{label}: {res.samples} cutouts")
        check(len(res.losses) == steps
              and all(math.isfinite(x) for x in res.losses),
              f"{label} losses not finite: {res.losses}")
        check(tuple(res.params.shape) == (1, 3, 720, 641, 2)
              and bool(torch.isfinite(res.params).all()),
              f"{label}: bad final params")
        run_dir = os.path.join(OUT_DIR, "switches", res.out_name)
        frames = [f for f in os.listdir(run_dir) if f.endswith(".jpg")]
        check(len(frames) == steps, f"{label}: {len(frames)} frames")
        check(got == want, f"{label}: launches {got} != expected {want}")
        if label.startswith(("(a)", "(d)")):
            for k in ("win_cut_fwd", "ln_fwd", "ln_bwd") + BLOCK_KERNELS:
                if k in report and k in got:
                    report[k]["launches"] = got[k]
        steady = sorted(res.step_seconds[1:] or res.step_seconds)
        print(f"[main] {label}: {steps} steps, {res.samples} cutouts, first "
              f"step {res.step_seconds[0]:.3f} s, steady "
              f"{1.0 / steady[len(steady) // 2]:.3f} steps/s on {name}; "
              f"losses {[round(x, 5) for x in res.losses]}")
        del res


# ---------------------------------------------------------------- loop

# (label, CLI flags, environment, opt_step, kernel launches a step, or a
# function of the steps giving the run's): the paths the `loop` phase
# replays, each against its eager steps
_B32 = {k: 12 for k in BLOCK_KERNELS}     # the fused halves, by default
_PALLAS = dict(_B32, cutout_fwd=1, cutout_bwd=1)
_DENSE = dict(_B32, **dense_cut(1))           # and the default cut
LOOP_PATHS = (
    ("default", [], None, 1, _DENSE),
    ("--pallas, opt_step 2", ["--pallas"], None, 2, _PALLAS),
    ("--pallas --persp exact", ["--pallas", "--persp", "exact"], None, 1,
     dict(_PALLAS, persp_fwd=2, persp_bwd=2)),
    ("--pallas -tf elastic, shift kernel", ["--pallas", "-tf", "elastic"],
     {"APHANTASIA_PALLAS_SHIFT": "1"}, 1, dict(_PALLAS, frac_shift=4)),
    ("(a) ViT-B/32, cutout + LN switches", [], SWITCHES, 1,
     dict(_B32, win_cut_fwd=1)),
    ("(b) ViT-L/14, cutout + LN switches", ["-m", "ViT-L/14"], SWITCHES, 1,
     {"attn_fwd": 24, "attn_bwd": 24, "win_cut_fwd": 1, "ln_fwd": 48,
      "ln_bwd": 48}),
    ("(d) ViT-B/32, fused block", [], FUSED, 1, _DENSE),
    ("(f) --dualmod 3, opt_step 2", ["--dualmod", "3"], None, 2,
     lambda steps: b32_dual(steps, len(range(3, steps, 3)), 0,
                            **dense_cut(steps))),
    ("(g) --sync 0.4 -i", ["--sync", "0.4", "-i", "{img}"], None, 1,
     _DENSE),
    ("(i) --dwt", ["--dwt"], None, 1, _DENSE),
    ("(j) -m RN50 --pallas", ["-m", "RN50", "--pallas"], None, 1,
     {"cutout_fwd": 1, "cutout_bwd": 1}),
)


def _fresh(su):
    """The run's start: params, optimizer state, prev_enc."""
    import torch
    p = su.gen_params
    p = [x.clone() for x in p] if isinstance(p, list) else p.clone()
    prev = torch.zeros((su.sampler.count, su.clip_cfg.embed_dim),
                       device=su.gen.device)
    return p, su.optimizer.init(p), prev


def _leaves(p, st, prev):
    """The state's tensors by name (a DWT pyramid's leaf by leaf)."""
    out = {"count": st.count, "prev_enc": prev}
    for name, v in (("params", p), ("mu", st.mu), ("nu", st.nu)):
        if isinstance(v, list):
            out.update({f"{name}{i}": x for i, x in enumerate(v)})
        else:
            out[name] = v
    return out


def _loop_eager(su, a, start):
    """The steps one by one (`build_train_step`, the render after each
    group's first step; under --dualmod the second tower where
    i % dualmod == 0 and i > 0), as the CLI's per-step loop runs them: the
    loss read after each step, the frame after each render."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.parallel import spatial
    from aphantasia_torch.step import build_render, build_train_step
    su.gen.set_state(start)
    if isinstance(su.par, spatial.SpatialCanvas):
        steps = [spatial.build_spatial_train_step(
            su.par, su.sampler, t.cfg, su.settings, su.optimizer)
            for t in su.towers]
        render = spatial.build_spatial_render(su.par)
    else:
        steps = [build_train_step(su.par, su.sampler, t.cfg, su.settings,
                                  su.optimizer, su.mesh) for t in su.towers]
        render = build_render(su.par)
    p, st, prev = _fresh(su)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, frames, secs = [], [], []
    for i in range(a.steps):
        t0 = time.perf_counter()
        tower = int(su.dm_every is not None and i % su.dm_every == 0
                    and i > 0)
        p, st, prev, loss = steps[tower](p, st, prev, *su.consts(tower),
                                         su.draw(su.gen), i // a.opt_step)
        losses.append(loss.item())
        if i % a.opt_step == 0:
            frames.append(render(p, contrast=a.contrast).cpu())
        secs.append(time.perf_counter() - t0)
    out = _leaves(p, st, prev)
    out.update(losses=torch.tensor(losses), frames=torch.stack(frames))
    return out, {"secs": secs, "peak": torch.cuda.max_memory_allocated(),
                 "launches": dict(kernels.LAUNCHES)}


def _loop_replayed(su, a, start, nf):
    """The same steps through `build_train_loop_frames`, `nf` frame groups
    a dispatch: each tower pattern's first group runs eagerly and is
    captured, every later group only replays, under sync debug mode
    "error" (a host sync raises) in every dispatch that only replays, up
    to the dispatch's one wait, the read of its losses.  The device ms of
    each pattern's graph, and of a step: each pattern's ms times the
    groups of that pattern, over the steps."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.parallel import spatial
    from aphantasia_torch.step import build_train_loop_frames
    su.gen.set_state(start)
    if isinstance(su.par, spatial.SpatialCanvas):
        loop = spatial.build_spatial_train_loop_frames(
            su.par, su.sampler, su.clip_cfg, su.settings, su.optimizer,
            a.opt_step, nf, contrast=a.contrast, dual=su.dual)
    else:
        loop = build_train_loop_frames(su.par, su.sampler, su.clip_cfg,
                                       su.settings, su.optimizer, a.opt_step,
                                       nf, contrast=a.contrast, dual=su.dual,
                                       mesh=su.mesh)
    p, st, prev = _fresh(su)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, frames, walls, late, replayed = [], [], [], 0.0, []
    for c in range(a.steps // a.opt_step // nf):
        t0 = time.perf_counter()
        replays = c and all(loop.pattern((c * nf + j) * a.opt_step)
                            in loop.groups for j in range(nf))
        torch.cuda.set_sync_debug_mode("error" if replays else 0)
        try:
            p, st, prev, f, dl = loop(p, st, prev, *su.loop_args(),
                                      lambda g: su.draw(su.gen), c * nf)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses += dl.tolist()
        walls.append(time.perf_counter() - t0)
        if c:   # a tower pattern's eager group and capture, met late
            late += sum(loop.first_runs.values())
            replayed += [loop.pattern((c * nf + j) * a.opt_step)
                         for j in range(nf) if j not in loop.first_runs]
        frames.append(f.cpu())
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the loop's own buffers, which the timing replays below move on
    out = {k: v.clone() for k, v in _leaves(p, st, prev).items()}
    out.update(losses=torch.tensor(losses), frames=torch.cat(frames))
    group_ms = {pat: cuda_ms(g.graph.graph.replay, iters=10, warmup=2)
                for pat, g in loop.groups.items()}
    uses = [loop.pattern(f * a.opt_step)
            for f in range(a.steps // a.opt_step)]
    step_ms = sum(group_ms[pat] for pat in uses) / a.steps
    first_group = loop.groups[loop.pattern(0)]
    # the replays after the first dispatch: their steps, their device ms
    # and their wall (those dispatches' walls less the late first runs)
    replay = (len(replayed) * a.opt_step,
              sum(group_ms[pat] for pat in replayed),
              sum(walls[1:]) - late)
    return out, {"walls": walls, "peak": peak, "launches": launches,
                 "first": first_group.first_seconds, "replay": replay,
                 "group_ms": group_ms, "step_ms": step_ms}


def phase_loop(steps: int = 16, nf: int = 2, paths=LOOP_PATHS):
    """The step loop on every path of LOOP_PATHS at full width (1280x720,
    200 samples before the budget, random weights from a seed): twice the
    eager steps (`build_train_step`), then the same steps from the same
    draws replayed from a CUDA graph (`build_train_loop_frames`, `nf`
    frame groups a dispatch).  Params, optimizer state, prev_enc, losses
    and frames must equal the eager run's bit for bit where the two eager
    runs agree bit for bit; where they do not, within twice the largest
    difference between the two eager runs.  Launch counts (per replay)
    must be the path's launches a step times the steps, in both runs.
    Reports steps/s eager (median step after the first) and replayed (the
    replays of the dispatches after the first; a tower pattern's eager
    run and capture met there is left out), each graph's device ms by CUDA
    events around back-to-back replays and a step's (the graphs' ms over
    the run's groups), the busy share (the timed replays' device ms over
    their wall) and the peak device memory of each run."""
    import torch
    from aphantasia_torch.cli import clip_fft
    name = torch.cuda.get_device_name(0)
    for label, extra, env, n, per_step in paths:
        extra = [sync_image() if x == "{img}" else x for x in extra]
        argv = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
                "--samples", "200", "--steps", str(steps * n), "--opt_step",
                str(n), "-nv", "--seed", "1",
                "--out_dir", os.path.join(OUT_DIR, "loop")] + extra
        with env_set(env):
            a = clip_fft.get_args(argv)
            su = clip_fft.setup(a)
            start = su.gen.get_state()
            runs = [_loop_eager(su, a, start) for _ in range(2)]
            got, rep = _loop_replayed(su, a, start, nf)
        (want, eager), (again, _) = runs
        want_launches = (per_step(a.steps) if callable(per_step) else
                         {k: v * a.steps for k, v in per_step.items()})
        check(eager["launches"] == want_launches
              and rep["launches"] == want_launches,
              f"loop {label}: launches eager {eager['launches']}, replayed "
              f"{rep['launches']}, expected {want_launches}")
        worst = {}
        for k, ref in want.items():
            check(got[k].shape == ref.shape, f"loop {label}: {k} shape "
                  f"{tuple(got[k].shape)} != {tuple(ref.shape)}")
            spread = (again[k].double() - ref.double()).abs().max().item()
            err = (got[k].double() - ref.double()).abs().max().item()
            worst[k] = (err, spread)
        off = (got["losses"] != want["losses"]).nonzero().flatten().tolist()
        check(all(e == 0 if sp == 0 else e <= 2 * sp
                  for e, sp in worst.values()),
              f"loop {label}: the replay differs from the eager run, max "
              f"|replayed - eager| (two eager runs): " + ", ".join(
                  f"{k} {e:.3g} ({sp:.3g})" for k, (e, sp) in worst.items())
              + f"; losses differ from step {off[:1]} on")
        check(all(math.isfinite(x) for x in got["losses"].tolist()),
              f"loop {label}: losses not finite")
        steady = sorted(eager["secs"][1:])
        eager_sps = 1.0 / steady[len(steady) // 2]
        # the replays of the dispatches after the first (a tower pattern's
        # eager run and capture met there left out, with its steps)
        n_rep, rep_ms, rep_wall = rep["replay"]
        replay_sps = n_rep / rep_wall
        busy = rep_ms / 1000 / rep_wall
        dev_ms = rep["step_ms"]
        exact = all(e == 0 for e, _ in worst.values())
        graphs = ", ".join(f"{''.join(str(t + 1) for t in pat)} "
                           f"{ms:.3f}" for pat, ms in rep["group_ms"].items())
        print(f"[loop] {label}: {a.steps} steps, {su.sampler.count} cutouts, "
              f"opt_step {a.opt_step}, {nf} groups a dispatch on {name}: "
              f"eager {eager_sps:.3f} steps/s, replayed {replay_sps:.3f} "
              f"steps/s; first dispatch {rep['walls'][0]:.3f} s (eager group "
              f"and capture {rep['first']:.3f} s); replayed group device "
              f"ms by tower pattern {graphs} ({dev_ms:.3f} a step), busy "
              f"share {busy:.3f}; peak memory eager "
              f"{eager['peak'] / 2**20:.0f} MiB, replayed "
              f"{rep['peak'] / 2**20:.0f} MiB; launches {want_launches}; "
              + ("bit for bit" if exact else
                 "max |replayed - eager| (eager spread): "
                 + ", ".join(f"{k} {e:.3g} ({sp:.3g})"
                             for k, (e, sp) in worst.items())))
        if su.lpips_bundle is not None:
            sync_term_ms(su)
        if su.par.__class__.__name__ == "DWTParameterizer":
            decode_ms(su)
        del su, runs, got
        torch.cuda.empty_cache()


def _coord_eager(su, steps, opt_step, with_params, start):
    """The steps one by one (`build_train_step`, step_i the global step),
    the render and, with `with_params`, a copy of the params after each
    group's first step, the loss read after each step."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.step import build_render, build_train_step
    su.gen.set_state(start)
    step = build_train_step(su.par, su.sampler, su.clip_cfg, su.settings,
                            su.optimizer)
    render = build_render(su.par)
    p, st, prev = _fresh(su)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, frames, snaps, secs = [], [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        p, st, prev, loss = step(p, st, prev, *su.consts(0), su.draw(su.gen),
                                 i)
        losses.append(loss.item())
        if i % opt_step == 0:
            frames.append(render(p).cpu())
            if with_params:
                snaps.append([x.detach().clone().cpu() for x in p])
        secs.append(time.perf_counter() - t0)
    out = _leaves(p, st, prev)
    out.update(losses=torch.tensor(losses), frames=torch.stack(frames))
    for k in range(len(snaps[0]) if snaps else 0):
        out[f"snap{k}"] = torch.stack([sn[k] for sn in snaps])
    return out, {"secs": secs, "peak": torch.cuda.max_memory_allocated(),
                 "launches": dict(kernels.LAUNCHES)}


def _coord_replayed(su, steps, opt_step, nf, with_params, step_index, start):
    """The same steps through `build_train_loop_frames` (`with_params`:
    the snapshots gathered with the frames), `nf` groups a dispatch, the
    dispatches after the first under sync debug mode "error"."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.step import build_train_loop_frames
    su.gen.set_state(start)
    loop = build_train_loop_frames(su.par, su.sampler, su.clip_cfg,
                                   su.settings, su.optimizer, opt_step, nf,
                                   step_index=step_index,
                                   with_params=with_params)
    p, st, prev = _fresh(su)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, frames, snaps, walls = [], [], [], []
    for c in range(steps // opt_step // nf):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if c else 0)
        try:
            p, st, prev, f, *sn, dl = loop(p, st, prev, *su.loop_args(),
                                           lambda g: su.draw(su.gen), c * nf)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses += dl.tolist()
        walls.append(time.perf_counter() - t0)
        frames.append(f.cpu())
        snaps += [[x.cpu() for x in sn[0]]] if sn else []
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    out = {k: v.clone() for k, v in _leaves(p, st, prev).items()}
    out.update(losses=torch.tensor(losses), frames=torch.cat(frames))
    for k in range(len(snaps[0]) if snaps else 0):
        out[f"snap{k}"] = torch.cat([sn[k] for sn in snaps])
    (group,) = loop.groups.values()
    ms = cuda_ms(group.graph.graph.replay, iters=10, warmup=2) / opt_step
    return out, {"walls": walls, "peak": peak, "launches": launches,
                 "first": group.first_seconds, "step_ms": ms}


# (label, CLI module name, flags, opt_step, with_params, step_index)
COORD_LOOP_PATHS = (
    ("cppn, --fstep 2, snapshots", "cppn",
     ["--fstep", "2"], 2, True, "step"),
    ("clip_vqgan imagenet_f16_16384", "clip_vqgan", ["-nv"], 1, False,
     "frame"),
)


def phase_loop_coord(steps: int = 16, nf: int = 2, paths=COORD_LOOP_PATHS):
    """cppn (a 10-layer CPPN at 512x512, `--fstep 2`, the per-group params
    snapshots) and clip_vqgan (the f16 decoder at 640x480, 190 cutouts)
    at full width, random weights from a seed, through each CLI's
    `setup`: twice the eager steps, then the same steps from the same
    draws through the frame loop (the first group eager and captured,
    every later one replayed); params, optimizer state, prev_enc, losses,
    frames and snapshots must equal the eager run's bit for bit (or, where
    the two eager runs part, within twice their spread), the launches
    (counted per replay) those of the eager steps.  Reports steps/s eager
    and replayed, the group's device ms a step by replay, busy share and
    peak memory."""
    import importlib
    import torch
    name = torch.cuda.get_device_name(0)
    for label, mod, extra, n, with_params, step_index in paths:
        cli = importlib.import_module(f"aphantasia_torch.cli.{mod}")
        a = cli.get_args(["-t", "a lighthouse on a cliff at dawn",
                          "--steps", str(steps), "--seed", "1", "--out_dir",
                          os.path.join(OUT_DIR, "loop_coord")] + extra)
        su = cli.setup(a)
        start = su.gen.get_state()
        runs = [_coord_eager(su, steps, n, with_params, start)
                for _ in range(2)]
        got, rep = _coord_replayed(su, steps, n, nf, with_params, step_index,
                                   start)
        (want, eager), (again, _) = runs
        check(eager["launches"] == rep["launches"]
              and eager["launches"].get("block_attn_bwd") == 12 * steps,
              f"loop {label}: launches eager {eager['launches']}, replayed "
              f"{rep['launches']}")
        check(got.keys() == want.keys(), f"loop {label}: {sorted(got)} != "
              f"{sorted(want)}")
        worst = {}
        for k, ref in want.items():
            check(got[k].shape == ref.shape, f"loop {label}: {k} shape")
            worst[k] = ((got[k].double() - ref.double()).abs().max().item(),
                        (again[k].double() - ref.double()).abs().max().item())
        check(all(e == 0 if sp == 0 else e <= 2 * sp
                  for e, sp in worst.values()),
              f"loop {label}: the replay differs from the eager run: "
              + ", ".join(f"{k} {e:.3g} ({sp:.3g})"
                          for k, (e, sp) in worst.items()))
        exact = all(e == 0 for e, _ in worst.values())
        steady = sorted(eager["secs"][1:])
        eager_sps = 1.0 / steady[len(steady) // 2]
        check(len(rep["walls"]) > 1, f"loop {label}: one dispatch only")
        replay_sps = (steps - nf * n) / sum(rep["walls"][1:])
        busy = rep["step_ms"] * replay_sps / 1000
        print(f"[loop] {label}: {steps} steps, {su.sampler.count} cutouts, "
              f"opt_step {n}, {nf} groups a dispatch on {name}: eager "
              f"{eager_sps:.3f} steps/s, replayed {replay_sps:.3f} steps/s; "
              f"first dispatch {rep['walls'][0]:.3f} s (eager group and "
              f"capture {rep['first']:.3f} s); device ms a step by replay "
              f"{rep['step_ms']:.3f}, busy share {busy:.3f}; peak memory "
              f"eager {eager['peak'] / 2**20:.0f} MiB, replayed "
              f"{rep['peak'] / 2**20:.0f} MiB; launches {rep['launches']}; "
              f"{len([k for k in got if k.startswith('snap')])} snapshot "
              f"leaves of {got['frames'].shape[0]} groups; "
              + ("bit for bit" if exact else "max |replayed - eager| "
                 "(eager spread): " + ", ".join(
                     f"{k} {e:.3g} ({sp:.3g})"
                     for k, (e, sp) in worst.items())))
        del su, runs, got
        torch.cuda.empty_cache()


def phase_cudnn():
    """(only when asked for) the (j) `-m RN50 --pallas` loop path of
    `phase_loop` once more with cuDNN free to pick nondeterministic
    algorithms (`torch.backends.cudnn.deterministic = False` after the
    CLI's own settings; `benchmark` stays off): its device ms a step and
    whether the replay still equals the eager steps bit for bit, beside
    the deterministic run of `loop`."""
    import torch
    from aphantasia_torch.cli import clip_fft
    settings = clip_fft.card_settings

    def free(device):
        settings(device)
        torch.backends.cudnn.deterministic = False
    clip_fft.card_settings = free
    try:
        phase_loop(paths=[p for p in LOOP_PATHS if p[0].startswith("(j)")])
    finally:
        clip_fft.card_settings = settings
        torch.backends.cudnn.deterministic = True
    print("[cudnn] the line above: (j) with cudnn.deterministic = False")


def _illustra_eager(su, scenes: int):
    """`scenes` scenes of the illustra setup `su` step by step
    (`build_train_step`, the render after each `save_step`-th step), the
    keep rescale and the carried optimizer state between them, each scene
    from its own generator: the state after the last, the losses, the
    frames."""
    import torch
    from aphantasia_torch.cli.illustra import keep_chain, scene_generator
    from aphantasia_torch.step import build_render, build_train_step
    sc, a = su.scenes, su.a
    step = build_train_step(sc.par, sc.sampler, sc.cfgs[0], sc.settings,
                            sc.optimizer)
    render = build_render(sc.par)
    p = su.start(0)
    st = sc.optimizer.init(p)
    losses, frames = [], []
    for num in range(scenes):
        if num:
            p = keep_chain(p, a.keep)
        gen = scene_generator(a.seed, num, 0, su.device)
        prev = torch.zeros((sc.sampler.count, sc.cfgs[0].embed_dim),
                           device=su.device)
        consts = su.consts(num)[0]
        for i in range(a.steps):
            p, st, prev, loss = step(p, st, prev, *consts, su.draw(gen), i)
            losses.append(loss.item())
            if i % a.save_step == 0:
                frames.append(render(p, contrast=a.contrast).cpu())
    out = _leaves(p, st, torch.zeros(()))
    del out["prev_enc"]
    out.update(losses=torch.tensor(losses), frames=torch.stack(frames))
    return out


def phase_loop_illustra(steps: int = 8):
    """The illustra chain over a scene boundary at full width (ViT-B/32,
    `--pallas`, 190 cutouts, the aesthetic head, two scenes of `steps`):
    the scenes through `SceneLoop.scene`, whose first frame group is
    captured into a CUDA graph in scene 1 and replayed for every later
    group, scene 2 after the copy-in of its rescaled spectrum, carried
    optimizer state, prompts and zeroed prev_enc; held to two eager runs
    (bit for bit, or within their own spread), with no second capture.
    Prints scene 2's replayed steps/s, its device ms a step by replay and
    its busy share."""
    import torch
    from aphantasia_torch.cli import illustra
    argv = ["-t", scenes_file(2), "--size", "1280-720", "--samples", "200",
            "--steps", str(steps), "--pallas", "-nv", "--seed", "1",
            "--out_dir", os.path.join(OUT_DIR, "loop_illustra")]
    su = illustra.setup(illustra.get_args(argv))
    runs = [_illustra_eager(su, 2) for _ in range(2)]
    sc, a = su.scenes, su.a
    p = su.start(0)
    st = sc.optimizer.init(p)
    losses, frames, secs, graphs = [], [], [], None
    for num in range(2):
        if num:
            p = illustra.keep_chain(p, a.keep)
        gen = illustra.scene_generator(a.seed, num, 0, su.device)
        t0 = time.perf_counter()
        p, st, ls, _ = sc.scene(p, st, su.consts(num),
                                lambda g, gen=gen: su.draw(gen),
                                lambda first, f: frames.append(f.cpu()))
        secs.append(time.perf_counter() - t0)
        losses += ls
        found = [(id(lp), pat, id(g.graph)) for lp in sc.loops.values()
                 for pat, g in lp.groups.items()]
        graphs = graphs or found
        check(found == graphs and len(found) == 1 and found[0][2] != id(None),
              f"illustra loop: graphs after scene {num + 1}: {found}, "
              f"after scene 1: {graphs}")
    got = {k: v.clone() for k, v in _leaves(p, st, torch.zeros(())).items()}
    del got["prev_enc"]
    got.update(losses=torch.tensor(losses), frames=torch.cat(frames))
    want, again = runs
    worst = {}
    for k, ref in want.items():
        check(got[k].shape == ref.shape, f"illustra loop: {k} shape")
        worst[k] = ((got[k].double() - ref.double()).abs().max().item(),
                    (again[k].double() - ref.double()).abs().max().item())
    check(all(e == 0 if sp == 0 else e <= 2 * sp for e, sp in worst.values()),
          "illustra loop: the replay differs from the eager scenes: "
          + ", ".join(f"{k} {e:.3g} ({sp:.3g})" for k, (e, sp) in
                      worst.items()))
    loop = next(iter(sc.loops.values()))
    group = next(iter(loop.groups.values()))
    ms = cuda_ms(group.graph.graph.replay, iters=10, warmup=2)
    exact = all(e == 0 for e, _ in worst.values())
    print(f"[loop] illustra, 2 scenes of {steps} steps, {sc.sampler.count} "
          f"cutouts, one graph captured in scene 1 and replayed in scene 2 "
          f"on {torch.cuda.get_device_name(0)}: scene walls "
          f"{secs[0]:.3f} / {secs[1]:.3f} s, scene 2 {steps / secs[1]:.3f} "
          f"steps/s replayed, group device ms {ms:.3f}, busy share "
          f"{ms * steps / 1000 / secs[1]:.3f}; "
          + ("bit for bit" if exact else "max |replayed - eager| (eager "
             "spread): " + ", ".join(f"{k} {e:.3g} ({sp:.3g})"
                                     for k, (e, sp) in worst.items())))
    del su, runs, got
    torch.cuda.empty_cache()


def _trip_eager(su, start):
    """`a.steps` frames of scene 1 of the illustrip setup `su`, each run
    eagerly from the frame step's public pieces (`motion_warp`, a fresh
    optimizer state unless --smooth, `train_step` `opt_step` times,
    `render`, and with depth `preview` and the DA-V2 forward through
    `mirror_fused_depth`), from the run generator's state `start`: the
    state after the last frame, the losses, frames and previews."""
    import torch
    from aphantasia_torch.motion.depthwarp import mirror_fused_depth
    a = su.a
    su.gen.set_state(start)
    fs = su.frame_steps()[0]
    _, vis, aest = su.towers[0]
    p = su.params.clone()
    st = su.optimizer.init(p)
    prev = torch.zeros((a.samples, su.towers[0][0].embed_dim),
                       device=su.device)
    sched = su.scene(0)
    dmap = (mirror_fused_depth(su.deptha, fs.preview(p)) if fs.with_depth
            else None)
    losses, frames, previews = [], [], []
    for ii in range(a.steps):
        _, prompts, motion = su.frame(sched, 0, ii)
        draws = [su.draw(su.gen) for _ in range(a.opt_step)]
        mot = torch.stack([torch.full((), float(v), device=su.device)
                           for v in motion])
        with torch.no_grad():
            p = fs.motion_warp(p, mot, dmap)
        if not a.smooth:
            st = su.optimizer.init(p)
        for k in range(a.opt_step):
            p, st, prev, loss = fs.train_step(p, st, prev, vis, aest, None,
                                              prompts, draws[k], ii)
            losses.append(loss.item())
        frames.append(fs.render(p, contrast=a.contrast).cpu())
        if fs.with_depth:
            with torch.no_grad():
                pv = fs.preview(p)
                dmap = mirror_fused_depth(su.deptha, pv)
            previews.append(pv.cpu())
    out = _leaves(p, st, prev)
    out.update(losses=torch.tensor(losses), frames=torch.stack(frames))
    if previews:
        out["previews"] = torch.cat(previews)
    return out


def _trip_replayed(su, start):
    """The same frames through `build_frame_step` and the depth helpers as
    `illustrip.run` drives them: the first frame eager and captured, the
    others replayed (and the DA-V2 forward from its own graph after the
    first), under sync debug mode "error" from the second frame on."""
    import torch
    a = su.a
    su.gen.set_state(start)
    (fs,) = su.frame_steps()
    helpers = su.depth_helpers()
    p = su.params.clone()
    st = su.optimizer.init(p)
    prev = torch.zeros((a.samples, su.towers[0][0].embed_dim),
                       device=su.device)
    sched = su.scene(0)
    _, vis, aest = su.towers[0]
    dmap = (helpers.infer(helpers.preview(p)) if helpers is not None
            else None)
    losses, frames, previews = [], [], []
    for ii in range(a.steps):
        torch.cuda.set_sync_debug_mode("error" if ii else 0)
        try:
            _, prompts, motion = su.frame(sched, 0, ii)
            draws = [su.draw(su.gen) for _ in range(a.opt_step)]
            args = (p, st, prev, vis, aest, prompts, draws, ii, motion)
            if helpers is not None:
                p, st, prev, frame, ls, pv = fs(*args, dmap)
                dmap = helpers.infer(pv)
                previews.append(pv)
            else:
                p, st, prev, frame, ls = fs(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses.append(ls)
        frames.append(frame)
    out = {k: v.clone() for k, v in _leaves(p, st, prev).items()}
    out.update(losses=torch.cat(losses).cpu(),
               frames=torch.stack(frames).cpu())
    if previews:
        out["previews"] = torch.cat(previews).cpu()
    return out, fs, helpers


TRIP_LOOP_PATHS = (
    ("RGB", ["--gen", "RGB"]),
    ("FFT --smooth", ["--gen", "FFT", "--smooth"]),
    ("FFT --depth 1", ["--gen", "FFT", "--depth", "1"]),
)


def phase_loop_illustrip(frames: int = 6, paths=TRIP_LOOP_PATHS):
    """illustrip frames at full width (ViT-B/32, 95 cutouts, 1280x720,
    `--opt_step 2`, `fast`, random weights from a seed) on RGB, FFT
    `--smooth` and FFT with depth (DA-V2 `b`): twice eagerly from the
    frame step's pieces, then through the frame step and the depth
    helpers (the first frame eager and captured, every later frame and
    DA-V2 forward replayed), from the same draws.  Params, optimizer
    state, prev_enc, losses, frames and previews must equal the eager
    frames bit for bit where the two eager runs agree bit for bit, else
    within twice their spread.  Prints the frame group's device ms by
    replay."""
    import torch
    from aphantasia_torch.cli import illustrip
    for label, flags in paths:
        a = illustrip.get_args(
            ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
             "--samples", "100", "--steps", str(frames), "--fstep", "4",
             "--opt_step", "2", "-nv", "--seed", "1", "--out_dir",
             os.path.join(OUT_DIR, "loop_trip")] + flags)
        su = illustrip.setup(a)
        start = su.gen.get_state()
        want, again = (_trip_eager(su, start) for _ in range(2))
        got, fs, helpers = _trip_replayed(su, start)
        worst = {}
        for k, ref in want.items():
            check(got[k].shape == ref.shape, f"illustrip loop {label}: {k} "
                  f"shape {tuple(got[k].shape)} != {tuple(ref.shape)}")
            worst[k] = ((got[k].double() - ref.double()).abs().max().item(),
                        (again[k].double() - ref.double()).abs().max().item())
        check(all(e == 0 if sp == 0 else e <= 2 * sp
                  for e, sp in worst.values()),
              f"illustrip loop {label}: the replay differs from the eager "
              f"frames: " + ", ".join(f"{k} {e:.3g} ({sp:.3g})"
                                      for k, (e, sp) in worst.items()))
        (group,) = fs.groups.values()
        check(group.graph is not None and (
            helpers is None or helpers.infer.graph is not None),
            f"illustrip loop {label}: no graph")
        ms = cuda_ms(group.graph.graph.replay, iters=10, warmup=2)
        extra = ""
        if helpers is not None:
            dav2 = cuda_ms(helpers.infer.graph.graph.replay, iters=10,
                           warmup=2)
            extra = f", DA-V2 graph {dav2:.3f}"
        exact = all(e == 0 for e, _ in worst.values())
        print(f"[loop] illustrip {label}: {frames} frames, {a.samples} "
              f"cutouts, opt_step 2, frame group device ms {ms:.3f}{extra} "
              f"on {torch.cuda.get_device_name(0)}; "
              + ("bit for bit" if exact else "max |replayed - eager| (eager "
                 "spread): " + ", ".join(f"{k} {e:.3g} ({sp:.3g})"
                                         for k, (e, sp) in worst.items())))
        del su, want, again, got, fs, helpers, group
        torch.cuda.empty_cache()


def sync_term_ms(su):
    """The `--sync` term alone at the run's shapes, by graph replay
    (`graph_ms`, 5 calls a graph): the resize of the 720x1280 frame, both
    VGG16 passes (frame and target, as the JAX step recomputes the
    constant target's features) and the frame's backward; the target's
    VGG16 features alone; and the float32 bound of the term's
    convolutions (their multiply-adds over the card's float32 rate)."""
    import torch
    from aphantasia_torch.models.lpips import _vgg_features, lpips_apply
    from aphantasia_torch.ops.resize import resize_bicubic
    params, target = su.lpips_bundle
    frame = torch.rand((1, 3) + tuple(su.par.size), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))

    def term():
        x = frame.detach().requires_grad_(True)
        d = lpips_apply(params, resize_bicubic(x, target.shape[-2:]), target)
        return torch.autograd.grad(d.mean(), x)[0]

    def features():
        return _vgg_features(params, target)
    h, w = target.shape[-2:]
    macs, cin, scale = 0, 3, 1
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512):
        if v == "M":
            scale *= 4
            continue
        macs += 9 * cin * v * (h * w // scale)
        cin = v
    # two forwards and the frame's input gradient (as many multiply-adds)
    bound = 3 * 2 * macs / PEAK_OPS["f32"] * 1e3
    print(f"[loop] the --sync term alone at {h}x{w} on "
          f"{torch.cuda.get_device_name(0)}: {graph_ms(term, 5):.3f} device "
          f"ms (forward both images, backward the frame), target features "
          f"alone {graph_ms(features, 5):.3f}; its convolutions' float32 "
          f"bound {bound:.3f} ms ({3 * 2 * macs / 1e9:.1f} GFLOP)")


def decode_ms(su):
    """The `--dwt` decode alone at the run's size, forward and the
    gradient of every subband, by graph replay, beside the FFT decode's
    at the same size."""
    import torch
    from aphantasia_torch.params.fft import FFTParameterizer
    gen = torch.Generator("cuda").manual_seed(0)
    co = torch.rand((1, 3) + tuple(su.par.size), device="cuda", generator=gen)
    fft = FFTParameterizer(tuple(su.par.size), 1.5, 1.8)
    for label, par, p0 in (("DWT", su.par, su.gen_params),
                           ("FFT", fft, [fft.init(gen, sd=0.07)])):
        def decode():
            xs = [x.detach().requires_grad_(True) for x in p0]
            img = par.image(xs if label == "DWT" else xs[0])
            return torch.autograd.grad(img, xs, co)
        print(f"[loop] the {label} decode alone at {su.par.size}: "
              f"{graph_ms(decode, 5):.3f} device ms forward and backward")


# ---------------------------------------------------------------- profile

def _device_us(evt) -> float:
    for key in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, key, None)
        if v is not None:
            return float(v)
    return 0.0


PROFILE_PATHS = (
    ("--pallas", ["--pallas"], None),
    ("default", [], None),
    ("--pallas --persp mixed", ["--pallas", "--persp", "mixed"], None),
    ("--pallas --persp exact", ["--pallas", "--persp", "exact"], None),
    ("--pallas -tf elastic, shift kernel", ["--pallas", "-tf", "elastic"],
     {"APHANTASIA_PALLAS_SHIFT": "1"}),
    ("--pallas -tf elastic", ["--pallas", "-tf", "elastic"], None),
    ("(a) default, both switches", [], SWITCHES),
    ("(a) default, windowed cut only", [], WIN_ONLY),
    ("(b) ViT-L/14, both switches", ["-m", "ViT-L/14"], SWITCHES),
    ("(b) ViT-L/14, windowed cut only", ["-m", "ViT-L/14"], WIN_ONLY),
    ("(c) ViT-L/14", ["-m", "ViT-L/14"], None),
    ("(d) ViT-B/32, fused block", [], FUSED),
    ("(e) ViT-B/32, all three switches", [], dict(SWITCHES, **FUSED)),
)


def phase_profile(only=(), steps: int = 6, active: int = 3):
    """Where a steady step's device time goes, for both cutout paths, the
    augmentation kernels' paths and the switches' paths with and without
    the fused LayerNorm, on the replayed loop: `build_train_loop_frames`
    one step a dispatch (the first the eager step and the capture, then
    replays), its loss read after each, torch.profiler over `active`
    steps after `steps - active` warm ones; the kernels by self device
    time per step, kernel launches per step, and the device busy share
    (kernel time over the host wall time of those steps).  `only`: the
    label prefixes of the paths to profile (all when empty)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from aphantasia_torch.cli import clip_fft
    from aphantasia_torch.step import build_train_loop_frames
    name = torch.cuda.get_device_name(0)
    for label, extra, env in PROFILE_PATHS:
        if only and not label.startswith(tuple(only)):
            continue
        argv = ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
                "--samples", "200", "--steps", str(steps), "-nv", "--seed",
                "1", "--out_dir", os.path.join(OUT_DIR, "profile")] + extra
        marks = []
        with env_set(env):
            a = clip_fft.get_args(argv)
            su = clip_fft.setup(a)
            loop = build_train_loop_frames(su.par, su.sampler, su.clip_cfg,
                                           su.settings, su.optimizer, 1, 1,
                                           contrast=a.contrast)
            state = _fresh(su)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=steps - active,
                                           active=active, repeat=1)) as prof:
                for i in range(steps):
                    *state, _, dl = loop(*state, *su.loop_args(),
                                         lambda g: su.draw(su.gen), i)
                    dl.tolist()
                    marks.append(time.perf_counter())
                    prof.step()
        wall = marks[-1] - marks[-1 - active]
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")]
        total = sum(_device_us(e) for e in evts) / 1e3 / active
        launches = sum(e.count for e in evts) / active
        check(total > 0, "the profiler saw no device time")
        print(f"[profile] {label}: {wall / active * 1e3:.2f} ms/step host "
              f"wall, {total:.2f} ms/step device kernels, {launches:.0f} "
              f"kernel launches/step, busy share "
              f"{total / (wall / active * 1e3):.3f} on {name}")
        for e in sorted(evts, key=_device_us, reverse=True)[:15]:
            ms = _device_us(e) / 1e3 / active
            print(f"[profile] {label}:   {ms:8.3f} ms/step "
                  f"{ms / total:6.1%}  x{e.count // active:<4d} "
                  f"{e.key[:90]}")


# ---------------------------------------------------------------- parity

PARITY_LR = 0.05


def _parity_setup(device, use_pallas, transform, persp="affine", count=6,
                  host_decode=False, kind="fft", resnet=False):
    """A small float32 step (tiny ViT of width 128 and 17 tokens, 96x64
    frame, `count` cutouts at 64) with the same weights, start and prompts
    on either device.  With `host_decode` the frame is decoded on the CPU
    and moved to `device`, the gradient back the same way, so both
    devices' cuts see the same frame bits.  `kind`: "fft" (the spectrum),
    "terms" (the spectrum with --aest 2 and --sync 0.5: a random head and
    random VGG16 weights, a 48x32 target, total_steps 4), "dwt" (a coif2
    pyramid of 6 levels), "cppn" (4 layers of 24, unbias), "siren" (3
    layers of 64, w0 30) or "vqgan" (a float32 decoder of width 32, levels
    (1, 2), its attentions, z 8).  `resnet`: a tiny ModifiedResNet tower in place
    of the ViT (width 8, stages (1, 2, 1, 1), its pool 256 wide in 4 heads
    over a 2x2 map).  `consts` are the step's (clip, aest, lpips_bundle,
    prompts)."""
    import torch
    from aphantasia_torch.models.clip.model import CLIPConfig, clip_init
    from aphantasia_torch.models.lpips import lpips_init
    from aphantasia_torch.ops.optim import build_optimizer
    from aphantasia_torch.ops.sampler import CutoutSampler
    from aphantasia_torch.params.dwt import DWTParameterizer
    from aphantasia_torch.params.fft import FFTParameterizer
    from aphantasia_torch.step import (StepSettings, build_draw_fn,
                                       build_loss_fn, build_train_step)
    cfg = (CLIPConfig("rn-tiny", 64, 64, (1, 2, 1, 1), 8, 0,
                      transformer_width=64, transformer_heads=2,
                      transformer_layers=1) if resnet else
           CLIPConfig("tiny", 64, 64, 2, 128, 16, transformer_width=64,
                      transformer_heads=2, transformer_layers=1))
    g = torch.Generator().manual_seed(0)
    clip = clip_init(g, cfg)
    clip = {"visual": _tree_to(clip["visual"], device)}
    par = FFTParameterizer((64, 96), 1.5, 1.8)
    if host_decode:
        class HostDecode(FFTParameterizer):
            def image(self, params, shift=None, contrast=1.0):
                return super().image(
                    params.cpu(), None if shift is None else shift.cpu(),
                    contrast).to(params.device)
        par = HostDecode((64, 96), 1.5, 1.8)
    if kind == "dwt":
        par = DWTParameterizer((64, 96), "coif2", 0.3, 1.8)
        p0 = [x.to(device) for x in par.init(g)]
    elif kind in ("cppn", "siren"):
        from aphantasia_torch.params.cppn import CPPNParameterizer
        from aphantasia_torch.params.siren import SIRENParameterizer
        par = (CPPNParameterizer((64, 96), 24, 4) if kind == "cppn"
               else SIRENParameterizer((64, 96), 64, 3))
        p0 = [x.to(device) for x in par.init(g)]
    elif kind == "vqgan":
        from aphantasia_torch.models import vqgan as V
        cfg_v = V.VQGANConfig("small", z_channels=8, ch=32, ch_mult=(1, 2),
                              num_res_blocks=1, attn_resolutions=(16,))
        par = V.VQGANParameterizer((64, 96), cfg_v, _tree_to(
            V.vqgan_init(g, cfg_v), device), torch.float32)
        p0 = par.init(g).to(device)
    else:
        p0 = par.init(g, sd=0.07).to(device)
    prompts = ((torch.randn((2, 64), generator=g).to(device),
                torch.tensor([1.0, 0.5], device=device), -1.0),)
    aest = bundle = None
    extra = {}
    if kind == "terms":
        aest = {"w": (0.1 * torch.randn((64, 1), generator=g)).to(device),
                "b": torch.full((1,), 0.2, device=device)}
        bundle = (_tree_to(lpips_init(g), device),
                  torch.rand((1, 3, 32, 48), generator=g).to(device))
        extra = dict(aest=2.0, sync=0.5, total_steps=4)
    sampler = CutoutSampler((64, 96), count, 64, "uniform", 0.4,
                            use_pallas=use_pallas)
    settings = StepSettings(sim="mix", transform=transform, persp=persp,
                            noise=0.1, sharp=0.2, expand=0.5,
                            clip_dtype=torch.float32, **extra)
    opt = build_optimizer("adam_custom", PARITY_LR, 2)
    shape = tuple(p0.shape) if kind in ("fft", "terms") else None
    return dict(clip=clip, p0=p0, prompts=prompts, opt=opt, cfg=cfg, g=g,
                par=par, sampler=sampler, settings=settings,
                consts=(clip, aest, bundle, prompts),
                draw=build_draw_fn(sampler, settings, shape),
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
    into a full-size update of that element).  The `--pallas` cut rounds
    the frame, its weights and its row pass to bf16, as the TPU kernel
    does, so a float32 difference between cuFFT's decode and the CPU's
    would flip a rounding: for those two steps both devices decode on the
    CPU (`host_decode`), and the card runs the cut's kernels, the tower
    and the optimiser on the same frame bits.  One step with the card's
    own decode is held at loss 1e-4 and gradient 1e-3, as the switches'
    paths are.  The `fast` transform (its affine, mixed and exact
    perspective) and `elastic` with the shift kernel are held at one
    step (`_parity_one_step`)."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.step import to_device
    _parity_one_step(True, "none", "affine", tol=(1e-4, 1e-3))
    for use_pallas in (True, False):
        runs = {}
        for dev in ("cpu", "cuda"):
            c = _parity_setup(dev, use_pallas, "none", host_decode=use_pallas)
            g = torch.Generator().manual_seed(1)
            p, st = c["p0"].clone(), c["opt"].init(c["p0"])
            prev = torch.zeros((6, 64), device=dev)
            losses = []
            for i in range(2):
                p, st, prev, loss = c["step"](p, st, prev, *c["consts"],
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
        _parity_one_step(use_pallas, "fast", "affine")
    # the augmentation kernels' paths: the perspective kernels (mixed,
    # exact) and the shift kernel (elastic with its switch on the card)
    for transform, persp, kernel, env in (
            ("fast", "mixed", "persp_bwd", None),
            ("fast", "exact", "persp_bwd", None),
            ("elastic", "affine", "frac_shift",
             {"APHANTASIA_PALLAS_SHIFT": "1"})):
        kernels.reset_launches()
        _parity_one_step(True, transform, persp, cuda_env=env)
        check(kernels.LAUNCHES[kernel] > 0,
              f"parity {transform}/{persp}: the card never launched {kernel}")
    # both switches on both devices: 61 cutouts of 17 tokens put 1037 rows
    # on the width-128 flat stream, so both gates open; on the card the
    # windowed cut runs once and the 2 blocks' 4 LayerNorms fuse each way
    kernels.reset_launches()
    _parity_one_step(False, "none", "affine", cuda_env=SWITCHES,
                     cpu_env=SWITCHES, count=61, tol=(1e-4, 1e-3))
    want = {"win_cut_fwd": 1, "ln_fwd": 4, "ln_bwd": 4}
    got = {k: kernels.LAUNCHES[k] for k in want}
    check(got == want, f"parity under the switches: launches {got} != {want}")
    # the fused half blocks on both devices: 17 tokens pass the geometry
    # gate, so each of the 2 blocks runs both halves each way on the card
    kernels.reset_launches()
    _parity_one_step(False, "none", "affine", cuda_env=FUSED, cpu_env=FUSED,
                     tol=(1e-4, 1e-3))
    want = {k: 2 for k in BLOCK_KERNELS}
    got = {k: kernels.LAUNCHES[k] for k in want}
    check(got == want and kernels.LAUNCHES["attn_bwd"] == 0,
          f"parity under the block switch: launches "
          f"{dict(kernels.LAUNCHES)}, expected {want} and no attn_bwd")
    # the paths of --aest with --sync (LPIPS on cuDNN, the bicubic resize)
    # and of --dwt, float32, one step each; then two --dualmod steps
    _parity_one_step(False, "none", "affine", tol=(1e-4, 1e-3), kind="terms")
    _parity_one_step(False, "none", "affine", tol=(1e-4, 1e-3), kind="dwt")
    _parity_dual()
    # the ModifiedResNet tower (cuDNN float32 convolutions on the card),
    # and a two-scene illustra chain replayed on the card.  The ResNet's
    # gradient is piecewise linear in the params (ReLU masks), and at
    # this size one mask flipped by a float32 rounding moves it by ~1e-3
    # relative L2 (in float64 on the CPU, a 1e-7 relative perturbation of
    # the params moves it by 9.0e-4): the gradient is held at 5e-3
    _parity_one_step(False, "none", "affine", tol=(1e-4, 5e-3), resnet=True)
    _parity_illustra()
    _parity_frames()
    # the coordinate nets' and the VQGAN decoder's steps (float32 products
    # and cuDNN convolutions on the card)
    for kind in ("cppn", "siren", "vqgan"):
        _parity_one_step(False, "none", "affine", tol=(1e-4, 1e-3), kind=kind)


def _parity_one_step(use_pallas, transform, persp, cuda_env=None,
                     cpu_env=None, count=6, tol=(2e-3, 2e-2), kind="fft",
                     resnet=False):
    """One step's loss and gradient on the CPU and on the card from the
    same draws, with `cpu_env` / `cuda_env` set for each device's run
    (`kind` as `_parity_setup`'s; a pyramid's gradient is held leaf by
    leaf as one vector).  The `fast` and `elastic` pipelines warp in bf16
    on both devices, so the default `tol`: loss within 2e-3 relative,
    gradient within 2e-2 relative L2 error; a float32 `none` step is held
    tighter by its caller."""
    import torch
    from aphantasia_torch.step import to_device
    grads = {}
    for dev, env in (("cpu", cpu_env), ("cuda", cuda_env)):
        with env_set(env):
            c = _parity_setup(dev, use_pallas, transform, persp, count,
                              kind=kind, resnet=resnet)
            listed = isinstance(c["p0"], list)
            p0 = c["p0"] if listed else [c["p0"]]
            xs = [x.clone().requires_grad_(True) for x in p0]
            d = to_device(c["draw"](torch.Generator().manual_seed(2)), dev)
            loss, _ = c["loss"](xs if listed else xs[0],
                                *c["consts"][:3], c["prompts"],
                                torch.zeros((count, 64), device=dev), d, 0)
            gr = torch.autograd.grad(loss, xs)
        grads[dev] = (loss.item(), torch.cat([x.cpu().flatten()
                                              for x in gr]))
    lr_ = abs(grads["cpu"][0] - grads["cuda"][0]) / abs(grads["cpu"][0])
    ge = ((grads["cpu"][1] - grads["cuda"][1]).norm()
          / grads["cpu"][1].norm()).item()
    print(f"[parity] {kind}{' ResNet' if resnet else ''} {transform}/{persp}, "
          f"pallas={use_pallas}, "
          f"{count} cutouts, env {sorted(cuda_env or {})}: loss cpu "
          f"{grads['cpu'][0]:.6f} cuda {grads['cuda'][0]:.6f}, grad "
          f"relative L2 error {ge:.3g}")
    check(lr_ <= tol[0] and ge <= tol[1],
          f"card vs CPU {kind} {transform}/{persp} step differs")


def _parity_dual():
    """Two steps of the dual frame loop (`dual=(cfg2, 1)`, one step a
    group: step 0 through the tiny tower, step 1 through a second one of
    patch 32 and 5 tokens) on the CPU and on the card, where each tower's
    group runs eagerly, is captured and is the graph of its pattern:
    losses within 1e-4, params within 2e-3 / 5e-2 of the learning rate
    (mean / worst), the second tower's graph built."""
    import torch
    from aphantasia_torch.models.clip.model import CLIPConfig, clip_init
    from aphantasia_torch.step import build_train_loop_frames, to_device
    runs = {}
    for dev in ("cpu", "cuda"):
        c = _parity_setup(dev, False, "none")
        cfg2 = CLIPConfig("tiny2", 64, 64, 2, 128, 32, transformer_width=64,
                          transformer_heads=2, transformer_layers=1)
        clip2 = {"visual": _tree_to(clip_init(c["g"], cfg2)["visual"], dev)}
        prompts2 = ((torch.randn((3, 64), generator=c["g"]).to(dev),
                     torch.tensor([1.0, 0.5, 0.25], device=dev), -1.0),)
        loop = build_train_loop_frames(c["par"], c["sampler"], c["cfg"],
                                       c["settings"], c["opt"], 1, 2,
                                       dual=(cfg2, 1))
        g = torch.Generator().manual_seed(3)
        p = c["p0"].clone()
        st, prev = c["opt"].init(p), torch.zeros((6, 64), device=dev)
        p, st, prev, _, losses = loop(
            p, st, prev, *c["consts"], clip2, None, prompts2,
            lambda gstep: to_device(c["draw"](g), dev), 0)
        check(sorted(loop.groups) == [(0,), (1,)]
              and (dev == "cpu" or all(gr.graph is not None
                                       for gr in loop.groups.values())),
              f"parity dual on {dev}: groups {sorted(loop.groups)}")
        runs[dev] = (losses.tolist(), p.cpu())
    le = max(abs(a - b) for a, b in zip(runs["cpu"][0], runs["cuda"][0]))
    err = (runs["cpu"][1] - runs["cuda"][1]).abs()
    print(f"[parity] dual (two towers, two steps): losses cpu "
          f"{runs['cpu'][0]} cuda {runs['cuda'][0]}; params |err| mean "
          f"{err.mean().item():.3g} max {err.max().item():.3g}")
    check(le <= 1e-4, f"dual: card vs CPU loss differs by {le}")
    check(err.mean().item() <= 2e-3 * PARITY_LR
          and err.max().item() <= 5e-2 * PARITY_LR,
          "dual: card vs CPU params differ")


def _parity_illustra(steps: int = 2):
    """Two illustra scenes of `steps` steps (`SceneLoop.scene`: one step a
    frame, the frames of a scene in one dispatch, the global step index,
    centred noise, no expand) on the CPU and on the card, where scene 1's
    first group is captured and everything after replays; between them
    the keep rescale (1.5), the carried optimizer state and new prompts.
    Losses within 1e-4, params within 2e-3 / 5e-2 of the learning rate
    (mean / worst)."""
    import dataclasses
    import torch
    from aphantasia_torch.cli.illustra import SceneLoop, keep_chain
    from aphantasia_torch.step import build_draw_fn, to_device
    runs = {}
    for dev in ("cpu", "cuda"):
        c = _parity_setup(dev, False, "none")
        settings = dataclasses.replace(c["settings"], expand=0.0,
                                       noise_centered=True)
        draw = build_draw_fn(c["sampler"], settings, tuple(c["p0"].shape))
        scenes = SceneLoop(c["par"], c["sampler"], [c["cfg"]], settings,
                           c["opt"], steps, 1, 1.1)
        prompts2 = ((torch.randn((2, 64), generator=c["g"]).to(dev),
                     torch.tensor([1.0, 0.25], device=dev), -1.0),)
        p = c["p0"].clone()
        st, losses = c["opt"].init(p), []
        g = torch.Generator().manual_seed(4)
        for num, prompts in enumerate((c["prompts"], prompts2)):
            if num:
                p = keep_chain(p, 1.5)
            consts = [(c["clip"], None, None,
                       [(e.clone(), w.clone(), k) for e, w, k in prompts])]
            p, st, ls, _ = scenes.scene(
                p, st, consts, lambda gs: to_device(draw(g), dev))
            losses += ls
        check(len(scenes.loops) == 1, f"parity illustra on {dev}: "
              f"{len(scenes.loops)} frame loops")
        runs[dev] = (losses, p.cpu())
    le = max(abs(a - b) for a, b in zip(runs["cpu"][0], runs["cuda"][0]))
    err = (runs["cpu"][1] - runs["cuda"][1]).abs()
    print(f"[parity] illustra, two scenes of {steps} steps (the second "
          f"replayed): losses cpu {runs['cpu'][0]} cuda {runs['cuda'][0]}; "
          f"params |err| mean {err.mean().item():.3g} max "
          f"{err.max().item():.3g}")
    check(le <= 1e-4, f"illustra: card vs CPU loss differs by {le}")
    check(err.mean().item() <= 2e-3 * PARITY_LR
          and err.max().item() <= 5e-2 * PARITY_LR,
          "illustra: card vs CPU params differ")


def _parity_frames():
    """Two illustrip frames (`build_frame_step`, opt_steps 2, the float32
    `none` transform, 6 overscan cutouts of a 64x96 frame, the tiny ViT)
    of RGB (pixels, `rgb_anchors`) and of FFT (centred spectrum noise) on
    the CPU and on the card, where the first frame runs eagerly and is
    captured and the second replays; each frame with its own motion and
    prompt weights, from the same draws.  Losses within 1e-4, the frames
    within 1 grey level, params within 2e-3 / 5e-2 of the learning rate
    (mean / worst)."""
    import dataclasses
    import torch
    from aphantasia_torch.cli.common import build_prompt_groups
    from aphantasia_torch.ops.sampler import CutoutSampler
    from aphantasia_torch.params.pixel import PixelParameterizer
    from aphantasia_torch.step import (build_draw_fn, build_frame_step,
                                       to_device)
    for gen in ("RGB", "FFT"):
        runs = {}
        for dev in ("cpu", "cuda"):
            c = _parity_setup(dev, False, "none")
            settings = dataclasses.replace(
                c["settings"], expand=0.0, sharp=0.0, noise_centered=True,
                noise=2.0 if gen == "FFT" else 0.0,
                rgb_anchors=gen == "RGB")
            sampler = CutoutSampler((64, 96), 6, 64, "overscan", 0.3)
            if gen == "RGB":
                par = PixelParameterizer((64, 96), 2.3)
                p = torch.randn((1, 3, 64, 96), generator=c["g"]).to(dev)
            else:
                par, p = c["par"], c["p0"].clone()
            draw = build_draw_fn(sampler, settings, tuple(p.shape))
            fs = build_frame_step(par, sampler, c["cfg"], settings, c["opt"],
                                  gen, (64, 96), 2, False, contrast=1.2)
            st, prev = c["opt"].init(p), torch.zeros((6, 64), device=dev)
            g = torch.Generator().manual_seed(5)
            losses, frames = [], []
            for ii, motion in enumerate([(3.0, 1.5, -2.0, 1.02, 0.5),
                                         (-1.0, -0.7, 2.5, 0.99, -0.3)]):
                e, wt, k = c["prompts"][0]
                prompts = build_prompt_groups(
                    [(e, wt * (1.0 - 0.3 * ii), k)])
                p, st, prev, frame, ls = fs(
                    p, st, prev, c["clip"], None, prompts,
                    [to_device(draw(g), dev) for _ in range(2)], ii, motion)
                losses += ls.tolist()
                frames.append(frame.cpu())
            check(dev == "cpu" or next(iter(fs.groups.values())).graph
                  is not None, f"parity frame {gen}: no graph on the card")
            runs[dev] = (losses, p.cpu(), torch.stack(frames))
        le = max(abs(a - b) for a, b in zip(runs["cpu"][0], runs["cuda"][0]))
        err = (runs["cpu"][1] - runs["cuda"][1]).abs()
        fd = (runs["cpu"][2].int() - runs["cuda"][2].int()).abs().max().item()
        print(f"[parity] illustrip {gen}, two frames of 2 steps (the second "
              f"replayed): losses cpu {runs['cpu'][0]} cuda "
              f"{runs['cuda'][0]}; params |err| mean {err.mean().item():.3g} "
              f"max {err.max().item():.3g}; frames max |diff| {fd} levels")
        check(le <= 1e-4, f"illustrip {gen}: card vs CPU loss differs by {le}")
        check(fd <= 1, f"illustrip {gen}: frames differ by {fd} levels")
        check(err.mean().item() <= 2e-3 * PARITY_LR
              and err.max().item() <= 5e-2 * PARITY_LR,
              f"illustrip {gen}: card vs CPU params differ")


# ---------------------------------------------------------------- mesh

def _children(cmds, env=None, timeout=600):
    """Run the commands (argv after the interpreter, extra environment)
    at once, each a child process, and return their (output, process);
    every child still running at the end is killed."""
    env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    procs = []
    try:
        for cmd, extra in cmds:
            procs.append(subprocess.Popen(
                [sys.executable] + cmd, cwd=ROOT, env=dict(env, **extra),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        return [(p.communicate(timeout=timeout)[0], p) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _files(d, exts=(".jpg", ".pt")) -> dict:
    """Every file under `d` with one of `exts` by its relative path ->
    bytes."""
    out = {}
    for dp, _, fs in os.walk(d):
        for f in fs:
            if not f.endswith(exts):
                continue
            path = os.path.join(dp, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = fh.read()
    return out


def _mesh_data_axis(steps: int):
    """(ad): the data axis at one rank, through a real NCCL group."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import clip_fft
    from aphantasia_torch.io.checkpoint import load_pt
    from aphantasia_torch.parallel.mesh import Plan, free_port, launch
    from aphantasia_torch.parallel import multihost
    name = torch.cuda.get_device_name(0)
    base = ["-t", "a lighthouse on a cliff at dawn", "--steps", str(steps),
            "-nv", "--seed", "1", "--save_pt"]
    mesh = ["--fleet", f"0/1@127.0.0.1:{free_port()}", "--mesh", "dcn"]
    runs, sps = {}, {"dense": [], "mesh": []}
    # in turns, dense, mesh, mesh, dense: the first runs of a process are
    # slower, whatever they run
    for i, label in enumerate(("dense", "mesh", "mesh", "dense")):
        extra = mesh if label == "mesh" else []
        multihost._reset_for_tests()
        out = os.path.join(OUT_DIR, "mesh", f"{label}{i}")
        shutil.rmtree(out, ignore_errors=True)
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = clip_fft.run(clip_fft.get_args(base + ["--out_dir", out]
                                             + extra))
        torch.cuda.synchronize()
        sps[label].append(_steady_sps(res.step_seconds))
        if label not in runs:
            runs[label] = (res, dict(kernels.LAUNCHES), out)
        del res
    multihost._reset_for_tests()
    (dense, dl, dout), (meshed, ml, mout) = runs["dense"], runs["mesh"]
    check(meshed.samples == dense.samples == 190,
          f"(ad): cutouts {meshed.samples}, {dense.samples}")
    check(meshed.losses == dense.losses and all(
        math.isfinite(x) for x in dense.losses),
          f"(ad): losses differ: {meshed.losses} vs {dense.losses}")
    df, mf = _files(dout), _files(mout)
    check(len(df) == steps + 2 and sorted(df) == sorted(mf)
          and all(df[k] == mf[k] for k in df),
          f"(ad): the frames and snapshots differ: "
          f"{[k for k in df if df[k] != mf.get(k)]}")
    pt = os.path.join(mout, meshed.out_name + ".pt")
    check(torch.equal(torch.as_tensor(load_pt(pt)[0]), meshed.params.cpu()),
          "(ad): the .pt is not the final params")
    coll = {"all_gather": steps, "all_reduce": steps}
    check(ml == dict(dl, **coll), f"(ad): launches {ml}, dense {dl}")
    groups = list(meshed.loop.groups.values())
    captured = {k: groups[0].graph.counts[k] for k in coll}
    check(len(groups) == 1 and captured == {"all_gather": 1,
                                            "all_reduce": 1},
          f"(ad): collectives in the captured group {captured}")
    print(f"[mesh] (ad) clip_fft --fleet 0/1@... --mesh dcn (one NCCL rank) "
          f"on {name}: {steps} steps, {meshed.samples} cutouts; losses, "
          f"{len(mf)} frame and snapshot files equal the dense run's byte "
          f"for byte; collectives {coll} ({captured} a replay of the captured "
          f"group); steady steps/s in turns dense {sps['dense'][0]:.3f}, mesh "
          f"{sps['mesh'][0]:.3f}, mesh {sps['mesh'][1]:.3f}, dense "
          f"{sps['dense'][1]:.3f}")
    del runs, dense, meshed
    torch.cuda.empty_cache()

    def replay_vs_eager():
        a = clip_fft.get_args(base + ["--out_dir",
                                      os.path.join(OUT_DIR, "mesh", "loop"),
                                      "--mesh", "dcn"])
        su = clip_fft.setup(a)
        start = su.gen.get_state()
        return ([_loop_eager(su, a, start) for _ in range(2)],
                _loop_replayed(su, a, start, 2))
    multihost._reset_for_tests()
    runs, (got, rep) = launch(replay_vs_eager, (), Plan(
        1, f"127.0.0.1:{free_port()}", "cuda"))
    (want, eager), (again, _) = runs
    per_step = dict(_DENSE, **{k: 1 for k in coll})
    want_launches = {k: v * steps for k, v in per_step.items()}
    check(eager["launches"] == want_launches == rep["launches"],
          f"(ad) loop: launches eager {eager['launches']}, replayed "
          f"{rep['launches']}, expected {want_launches}")
    off = [k for k in want if not (torch.equal(got[k], want[k])
                                   and torch.equal(again[k], want[k]))]
    check(not off, f"(ad) loop: the replay or the second eager run differs "
          f"in {off}")
    n_rep, rep_ms, rep_wall = rep["replay"]
    print(f"[mesh] (ad) loop: {steps} steps of the one-rank NCCL mesh on "
          f"{name}: eager {_steady_sps(eager['secs']):.3f} steps/s, replayed "
          f"{n_rep / rep_wall:.3f} steps/s, group device ms "
          f"{rep['step_ms']:.3f} a step; launches a step {per_step}; replayed "
          f"bit for bit")
    del runs, got
    torch.cuda.empty_cache()


def _mesh_illustra_fleet(steps: int) -> str:
    """(ae): illustra as a fleet of two processes on the one card; returns
    the directory of its snapshots."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import illustra
    from aphantasia_torch.io.checkpoint import load_pt
    from aphantasia_torch.parallel.mesh import free_port
    from aphantasia_torch.parallel import multihost
    out, ref = (os.path.join(OUT_DIR, "mesh", d) for d in ("fleet", "one"))
    for d in (out, ref):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["-t", scenes_file(3), "--steps", str(steps), "-nv", "--seed",
            "1", "--save_pt"]
    port = free_port()
    t0 = time.perf_counter()
    done = _children([(["-m", "aphantasia_torch.cli.illustra"] + argv
                       + ["--out_dir", out, "--fleet",
                          f"{r}/2@127.0.0.1:{port}"], {})
                      for r in range(2)],
                     env={"APHANTASIA_FLEET_WAIT": "600"})
    wall = time.perf_counter() - t0
    for r, (text, p) in enumerate(done):
        check(p.returncode == 0, f"(ae) fleet rank {r} failed:\n"
              f"{text[-3000:]}")
    shares = [re.search(r"fleet (\d)/2: scenes (\[[\d, ]*\]) of 3", t)
              for t, _ in done]
    check([m and (m.group(1), m.group(2)) for m in shares]
          == [("0", "[0, 2]"), ("1", "[1]")],
          f"(ae): the ranks' scenes {[m and m.group(0) for m in shares]}")
    finals = [f for f in os.listdir(os.path.join(out, "_final"))
              if f.endswith(".jpg")]
    videos = [f for f in os.listdir(out) if f.startswith("scenes3.")]
    check(len(finals) == 75 and videos,
          f"(ae): rank 0 assembled {len(finals)} crossfade frames, video "
          f"{videos}")
    multihost._reset_for_tests()
    kernels.reset_launches()
    one = illustra.run(illustra.get_args(argv + ["--out_dir", ref,
                                                 "--separate"]))
    torch.cuda.synchronize()
    want = b32(3 * steps, 36, **dense_cut(3 * steps))
    check(len(one.out_names) == 3 and dict(kernels.LAUNCHES) == want,
          f"(ae): {one.out_names}, launches {dict(kernels.LAUNCHES)}, "
          f"expected {want}")
    for n in one.out_names:
        a = torch.as_tensor(load_pt(os.path.join(out, n + ".pt")))
        b = torch.as_tensor(load_pt(os.path.join(ref, n + ".pt")))
        check(torch.equal(a, b), f"(ae): scene {n} differs from the "
              f"one-process run, max {float((a - b).abs().max()):.3g}")
    print(f"[mesh] (ae) illustra fleet of 2 processes on "
          f"{torch.cuda.get_device_name(0)}: scenes [0, 2] and [1] of 3, "
          f"{steps} steps each, {len(finals)} crossfade frames assembled by "
          f"rank 0, wall {wall:.1f} s; every scene's .pt equals the "
          f"one-process --separate run's bit for bit (its launches {want})")
    del one
    torch.cuda.empty_cache()
    return out


def _mesh_interpol_fleet(pts: str):
    """(af): interpol as two processes without a coordinator."""
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import interpol
    from aphantasia_torch.parallel import multihost
    out, ref = (os.path.join(OUT_DIR, "mesh", d) for d in ("pts2", "pts1"))
    for d in (out, ref):
        shutil.rmtree(d, ignore_errors=True)
    args = ["-m", "aphantasia_torch.cli.interpol", "-i", pts, "-s", "4",
            "-o", out]
    t0 = time.perf_counter()
    done = _children([(args + ["--fleet", "1/2"], {}),
                      (args, {"APHANTASIA_FLEET": "0/2"})],
                     env={"APHANTASIA_FLEET_WAIT": "300"})
    wall = time.perf_counter() - t0
    for r, (text, p) in enumerate(done):
        check(p.returncode == 0, f"(af) interpol process {r} failed:\n"
              f"{text[-3000:]}")
    multihost._reset_for_tests()
    kernels.reset_launches()
    interpol.main(["-i", pts, "-s", "4", "-o", ref, "-v", ""])
    check(not any(kernels.LAUNCHES.values()),
          f"(af): launches {dict(kernels.LAUNCHES)}")
    got, want = _files(os.path.join(out, "a")), _files(os.path.join(ref, "a"))
    check(len(want) == 12 and got == want,
          f"(af): {len(got)} fleet frames, {len(want)} one-process frames, "
          f"differing {[k for k in want if got.get(k) != want[k]]}")
    print(f"[mesh] (af) interpol fleet of 2 processes (one from --fleet 1/2, "
          f"one from APHANTASIA_FLEET=0/2) on 3 snapshots: {len(got)} frames "
          f"equal to one process's byte for byte, wall {wall:.1f} s")


def phase_mesh(steps: int = 8):
    """(ad), (ae) and (af): see the module docstring."""
    _mesh_data_axis(steps)
    _mesh_interpol_fleet(_mesh_illustra_fleet(steps))


# ---------------------------------------------------------------- spatial

SP_KEYS = ("sp_all_reduce", "sp_all_to_all", "sp_all_gather", "sp_halo")
# the spatial collectives a step launches at one rank (no halo: n = 1):
# FFT: the decode's all-to-all and moments, the cuts' sum, the moments'
# and the all-to-all's backward, and the render's decode and row gather;
# DWT: the decode's moments, the cuts' sum, the moments' backward, the
# whole leaves' gradient sum and the render's moments and row gather
SP_STEP = {"fft": {"sp_all_reduce": 4, "sp_all_to_all": 3,
                   "sp_all_gather": 1},
           "dwt": {"sp_all_reduce": 5, "sp_all_gather": 1}}
# an illustrip frame of opt_step 2: the warp's raw decode, row gather and
# encode, two steps, the render, and with depth the preview's raw decode
# and gather (RGB: no transform; the anchors' sums a step)
SP_FRAME = {"FFT --depth 1": {"sp_all_to_all": 8, "sp_all_reduce": 7,
                              "sp_all_gather": 3},
            "RGB": {"sp_all_reduce": 9, "sp_all_gather": 2}}


def _spatial_launch(fn, *args):
    """fn(*args) on a spatial axis of one NCCL rank: an in-process group of
    one rank on the card (NCCL refuses two ranks on one GPU)."""
    from aphantasia_torch.parallel import multihost
    from aphantasia_torch.parallel.mesh import Plan, free_port, launch
    multihost._reset_for_tests()
    return launch(fn, args, Plan(1, f"127.0.0.1:{free_port()}", "cuda"))


def _sp_counts(launches, scale=1):
    return {k: v // scale for k, v in launches.items() if k in SP_KEYS}


def _loss_grad(loss_fn, params, consts, prev, draws, i, spar=None):
    """(loss, gradient leaves) of loss_fn at `params`; with `spar` the
    whole leaves' gradients summed over its group and the gradient
    gathered to the canonical layout."""
    import torch
    from aphantasia_torch.ops.optim import leaves
    ps = [x.detach().clone().requires_grad_(True) for x in leaves(params)]
    loss, _ = loss_fn(ps if isinstance(params, list) else ps[0], *consts,
                      prev, draws, i)
    g = list(torch.autograd.grad(loss, ps))
    loss = loss.detach()
    if spar is not None:
        spar.reduce_grads(g)
        full = spar.full(g if isinstance(params, list) else g[0])
        g = full if isinstance(full, list) else [full]
    return float(loss), g


def _grad_err(gs, gd) -> float:
    """||gs - gd|| / ||gd|| over every leaf."""
    num = sum(float((a.double() - b.double()).pow(2).sum())
              for a, b in zip(gs, gd))
    den = sum(float(b.double().pow(2).sum()) for b in gd)
    return math.sqrt(num / den)


# the spatial step at one rank differs from the dense step only in the
# frame's float32 rounding (a one-pass variance, the pad-free ifft/irfft
# split; 2e-7 of the frame).  Held in float32 without the augmentations
# (`--precision fp32 -tf none`: the `fast` pipeline warps in bf16), the
# loss and the gradient move by ~1e-7 and ~1e-6 of themselves (the CPU
# rehearsal at a tiny size), and the bounds are ten times that and more.
# In bf16 with the default `fast` pipeline a cut element whose float32
# value moved may round to the other bf16 neighbour, 2^-8 away, and the
# tower's bf16 backward spreads such flips: those numbers are printed,
# not bounded.
SP_LOSS_REL, SP_GRAD_REL = 1e-5, 1e-4


def _spatial_checks(su_d, su_s, steps: int) -> dict:
    """The decode and the float32 cut of the sharded canvas against the
    dense ones from the same params and draws (2e-4), then each step's
    loss and gradient from the dense trajectory's params (its own draws,
    free running): the worst relative errors."""
    import torch
    from aphantasia_torch.ops.optim import leaves
    from aphantasia_torch.parallel.spatial import build_spatial_loss_fn
    from aphantasia_torch.step import build_loss_fn, build_train_step
    spar, par = su_s.par, su_d.par
    p0 = su_d.gen_params
    s0 = su_s.gen_params
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(spar.full(s0)), leaves(p0)))
    with torch.no_grad():
        img = par.image(p0)
        rgb = spar.rgb_rows(s0)
        h = img.shape[2]
        dec = (rgb[:, :, :h] - img).abs().max().item()
        d = su_d.draw(su_d.gen)
        wy, wx = su_s.sampler.weight_matrices(d.cuts.boxes)
        cut_d = su_d.sampler.cut(img, d.cuts.boxes, compute_dtype=torch.float32)
        cut_s = spar.cut(rgb, spar.pad_wy(wy), wx, torch.float32)
        cut = ((cut_s - cut_d).abs().max() / cut_d.abs().max()).item()
    lf_d = build_loss_fn(par, su_d.sampler, su_d.clip_cfg, su_d.settings)
    lf_s = build_spatial_loss_fn(spar, su_s.sampler, su_s.clip_cfg,
                                 su_s.settings)
    step = build_train_step(par, su_d.sampler, su_d.clip_cfg, su_d.settings,
                            su_d.optimizer)
    p = [x.clone() for x in p0] if isinstance(p0, list) else p0.clone()
    st = su_d.optimizer.init(p)
    prev = torch.zeros((su_d.sampler.count, su_d.clip_cfg.embed_dim),
                       device=su_d.gen.device)
    loss_err = grad_err = 0.0
    for i in range(steps):
        d = su_d.draw(su_d.gen)
        ld, gd = _loss_grad(lf_d, p, su_d.consts(0), prev, d, i)
        ls, gs = _loss_grad(lf_s, spar.shard(p), su_s.consts(0), prev, d, i,
                            spar)
        loss_err = max(loss_err, abs(ls - ld) / abs(ld))
        grad_err = max(grad_err, _grad_err(gs, gd))
        p, st, prev, _ = step(p, st, prev, *su_d.consts(0), d, i)
    return {"same_start": same, "decode": dec, "cut": cut,
            "loss": loss_err, "grad": grad_err}


def _spatial_clip_fft(label: str, kind: str, flags, steps: int):
    """(ag) or (ah): clip_fft at its defaults (ViT-B/32, 1280x720, 190
    cutouts, the chunked path) through its spatial set-up on one NCCL
    rank against the dense run."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import clip_fft
    name = torch.cuda.get_device_name(0)
    base = ["-t", "a lighthouse on a cliff at dawn", "--steps", str(steps),
            "-nv", "--seed", "1"] + flags

    def args(tag, extra=()):
        out = os.path.join(OUT_DIR, "spatial", kind, tag)
        shutil.rmtree(out, ignore_errors=True)
        return clip_fft.get_args(base + ["--out_dir", out] + list(extra))
    sps, runs = {"dense": [], "spatial": []}, {}
    # in turns, dense, spatial, spatial, dense (ag) or dense, spatial (ah)
    order = (("dense", "spatial", "spatial", "dense") if kind == "fft"
             else ("dense", "spatial"))
    for i, run in enumerate(order):
        torch.cuda.synchronize()
        kernels.reset_launches()
        if run == "dense":
            res = clip_fft.run(args(f"dense{i}"))
        else:
            res = _spatial_launch(lambda a: clip_fft._run(a, spatial=1),
                                  args(f"spatial{i}"))
        torch.cuda.synchronize()
        sps[run].append(_steady_sps(res.step_seconds))
        runs.setdefault(run, (res, dict(kernels.LAUNCHES)))
        del res
    (dense, dl), (sp, sl) = runs["dense"], runs["spatial"]
    want = {k: v * steps for k, v in SP_STEP[kind].items()}
    # the run's end gathers the canonical params once
    cli = dict(want, sp_all_gather=want["sp_all_gather"] + 1)
    check(sp.samples == dense.samples == 190 and len(sp.losses) == steps
          and all(math.isfinite(x) for x in sp.losses),
          f"{label}: cutouts {sp.samples}, losses {sp.losses}")
    # the spatial cut contracts its shard of the frame through `_contract`
    # (no kernel of the port), the dense run through the contraction pair
    dl_rest = {k: v for k, v in dl.items() if k not in dense_cut(0)}
    check(_sp_counts(sl) == cli and {k: v for k, v in sl.items()
                                      if k not in SP_KEYS} == dl_rest
          and dl == dict(dl_rest, **dense_cut(steps)),
          f"{label}: launches {sl}, dense {dl}, spatial collectives "
          f"expected {cli}")

    def inner():
        fp32 = ["--precision", "fp32", "-tf", "none"]
        su_d = clip_fft.setup(args("checks_dense", fp32))
        su_s = clip_fft.setup(args("checks_spatial", fp32), spatial=1)
        errs = _spatial_checks(su_d, su_s, steps)
        del su_d, su_s
        a_d, a_s = args("loop_dense"), args("loop_spatial")
        su_d, su_s = clip_fft.setup(a_d), clip_fft.setup(a_s, spatial=1)
        bf16 = _spatial_checks(su_d, su_s, steps)
        start = su_s.gen.get_state()
        eager = [_loop_eager(su_s, a_s, start) for _ in range(2)]
        got, rep = _loop_replayed(su_s, a_s, start, 2)
        _, rep_d = _loop_replayed(su_d, a_d, su_d.gen.get_state(), 2)
        return errs, bf16, eager, got, rep, rep_d
    errs, bf16, eager, got, rep, rep_d = _spatial_launch(inner)
    (want_e, e1), (again, _) = eager
    off = [k for k in want_e if not (torch.equal(got[k], want_e[k])
                                     and torch.equal(again[k], want_e[k]))]
    check(errs["same_start"] and errs["decode"] <= 2e-4
          and errs["cut"] <= 2e-4 and errs["loss"] <= SP_LOSS_REL
          and errs["grad"] <= SP_GRAD_REL,
          f"{label}: against the dense step in float32 {errs}")
    check(not off, f"{label}: the replay or the second eager run differs "
          f"in {off}")
    check(_sp_counts(rep["launches"]) == want == _sp_counts(e1["launches"]),
          f"{label}: replayed collectives {rep['launches']}, expected {want}")
    print(f"[spatial] {label} on {name}: one NCCL rank, {steps} steps, "
          f"{sp.samples} cutouts; against the dense step: decode "
          f"{errs['decode']:.3g}, float32 cut {errs['cut']:.3g} of max, "
          f"worst step loss {errs['loss']:.3g} and gradient "
          f"{errs['grad']:.3g} relative in float32 without augmentations "
          f"(bounds {SP_LOSS_REL}, "
          f"{SP_GRAD_REL}), in bf16 with `fast` {bf16['loss']:.3g} and "
          f"{bf16['grad']:.3g}; replay = eager bit for bit; collectives a step "
          f"{SP_STEP[kind]} (in the captured group, counted per replay); "
          f"steady steps/s in turns "
          + ", ".join(f"{r} {sps[r][j]:.3f}" for j, r in (
              (0, "dense"), (0, "spatial"), (1, "spatial"), (1, "dense"))
              if j < len(sps[r]))
          + f"; device ms a step by replay: spatial {rep['step_ms']:.3f}, "
          f"dense {rep_d['step_ms']:.3f}; peak MiB replayed spatial "
          f"{rep['peak'] / 2**20:.0f}, dense {rep_d['peak'] / 2**20:.0f}")
    del runs, dense, sp, eager, got
    torch.cuda.empty_cache()


def _trip_first_frame(su_d, su_s) -> dict:
    """The first frame of two illustrip setups, dense and spatial, from
    one state: the motion warp (relative to max), with depth the preview
    (absolute) and the warp by the dense depth map, then the first step's
    loss and gradient (relative) from the warped states."""
    import torch
    from aphantasia_torch.parallel.spatial import build_spatial_loss_fn
    from aphantasia_torch.step import build_loss_fn
    spar, cfg = su_s.spar, su_d.towers[0][0]
    fs_d, fs_s = su_d.frame_steps()[0], su_s.frame_steps()[0]
    p0, s0 = su_d.params, su_s.params
    out = {}
    with torch.no_grad():
        dmap = None
        if fs_d.with_depth:
            hd, hs = su_d.depth_helpers(), su_s.depth_helpers()
            pv_d, pv_s = hd.preview(p0), hs.preview(s0)
            out["preview"] = (pv_s - pv_d).abs().max().item()
            dmap = hd.infer(pv_d).clone()
        _, prompts, motion = su_d.frame(su_d.scene(0), 0, 0)
        mot = torch.tensor(motion, dtype=torch.float32, device=su_d.device)
        w_d = fs_d.motion_warp(p0, mot, dmap)
        w_s = fs_s.motion_warp(s0, mot, dmap)
        out["warp"] = ((spar.full(w_s) - w_d).abs().max()
                       / w_d.abs().max()).item()
    d = su_d.draw(su_d.gen)
    _, vis, aest = su_d.towers[0]
    prev = torch.zeros((su_d.sampler.count, cfg.embed_dim),
                       device=su_d.device)
    consts = (vis, aest, None, prompts)
    ld, gd = _loss_grad(build_loss_fn(su_d.par, su_d.sampler, cfg,
                                      su_d.settings), w_d, consts, prev, d, 0)
    ls, gs = _loss_grad(build_spatial_loss_fn(spar, su_s.sampler, cfg,
                                              su_s.settings),
                        w_s, consts, prev, d, 0, spar)
    out["loss"], out["grad"] = abs(ls - ld) / abs(ld), _grad_err(gs, gd)
    return out


def _spatial_illustrip(label: str, flags, frames: int):
    """(ai) or (aj): illustrip at 95 cutouts (ViT-B/32, 1280x720,
    `--opt_step 2`) through its spatial set-up on one NCCL rank."""
    import torch
    from aphantasia_torch import kernels
    from aphantasia_torch.cli import illustrip
    name = torch.cuda.get_device_name(0)
    kind = "FFT --depth 1" if "--depth" in flags else "RGB"

    def args(tag, n=frames, extra=()):
        return illustrip.get_args(
            ["-t", "a lighthouse on a cliff at dawn", "--size", "1280-720",
             "--samples", "100", "--steps", str(n), "--fstep", "4",
             "--opt_step", "2", "-nv", "--seed", "1", "--out_dir",
             os.path.join(OUT_DIR, "spatial", label[:4], tag)] + flags
            + list(extra))

    def first_frame(fp32):
        """The first frame from one state, spatial against dense."""
        extra = ["--precision", "fp32", "-tf", "none"] if fp32 else []
        a_d, a_s = args("dense", 4, extra), args("spatial", 4, extra)
        su_d, su_s = illustrip.setup(a_d), illustrip.setup(a_s, spatial=1)
        return _trip_first_frame(su_d, su_s), su_s

    def inner():
        out, su_s = first_frame(True)
        bf16, su_s = first_frame(False)
        start = su_s.gen.get_state()
        want, again = (_trip_eager(su_s, start) for _ in range(2))
        got, fs, helpers = _trip_replayed(su_s, start)
        worst = {k: ((got[k].double() - v.double()).abs().max().item(),
                     (again[k].double() - v.double()).abs().max().item())
                 for k, v in want.items()}
        del su_s, want, again, got, fs, helpers
        torch.cuda.empty_cache()
        a_cli = args("cli")
        kernels.reset_launches()
        res = illustrip._run(a_cli, spatial=1)
        torch.cuda.synchronize()
        return (out, bf16, worst, _trip_stats(res, a_cli),
                dict(kernels.LAUNCHES), res.frames)
    out, bf16, worst, stats, launches, n = _spatial_launch(inner)
    multihost_reset()
    kernels.reset_launches()
    a_dense = args("dense_cli")
    dense = illustrip.run(a_dense)
    torch.cuda.synchronize()
    stats_d = _trip_stats(dense, a_dense)
    want = {k: v * n for k, v in SP_FRAME[kind].items()}
    # the run's end gathers the canonical state once
    want["sp_all_gather"] += 1
    if "--depth" in flags:
        # the first frame's depth map: one preview before the frames
        want["sp_all_to_all"] += 1
        want["sp_all_gather"] += 1
    check(out["warp"] <= 2e-4 and out.get("preview", 0.0) <= 2e-4
          and out["loss"] <= SP_LOSS_REL and out["grad"] <= SP_GRAD_REL,
          f"{label}: against the dense frame step in float32 {out}")
    check(all(e == 0 if sp == 0 else e <= 2 * sp for e, sp in worst.values()),
          f"{label}: the replay differs from the eager frames: {worst}")
    check(_sp_counts(launches) == want,
          f"{label}: collectives {launches}, expected {want}")
    exact = all(e == 0 for e, _ in worst.values())
    print(f"[spatial] {label} on {name}: one NCCL rank, 95 cutouts, opt_step "
          f"2; the first frame against the dense frame step: warp "
          f"{out['warp']:.3g} of max"
          + (f", depth preview {out['preview']:.3g}" if "preview" in out
             else "")
          + f", loss {out['loss']:.3g} and gradient {out['grad']:.3g} "
          f"relative in float32 without augmentations, in bf16 with `fast` "
          f"{bf16['loss']:.3g} and "
          f"{bf16['grad']:.3g}; replay " + ("= eager bit for bit" if exact else
                                  f"within twice the eager spread {worst}")
          + f"; collectives a frame {SP_FRAME[kind]}; frames/min spatial "
          f"{stats[1]:.1f} (device ms a frame {stats[2]:.3f}, busy "
          f"{stats[3]:.3f}), dense {stats_d[1]:.1f} ({stats_d[2]:.3f}, "
          f"{stats_d[3]:.3f})")
    del dense
    torch.cuda.empty_cache()


def multihost_reset():
    from aphantasia_torch.parallel import multihost
    multihost._reset_for_tests()


def _spatial_4k():
    """(ak): one frame group of clip_fft at 3840x2160, spatial (one NCCL
    rank) against dense: the group's device ms by replay and the peak
    memory of its eager run, capture and replay."""
    import torch
    from aphantasia_torch.cli import clip_fft
    base = ["-t", "a lighthouse on a cliff at dawn", "--size", "3840-2160",
            "--steps", "2", "-nv", "--seed", "1", "--out_dir",
            os.path.join(OUT_DIR, "spatial", "4k")]

    def one(spatial):
        a = clip_fft.get_args(base)
        su = clip_fft.setup(a, spatial=spatial)
        _, rep = _loop_replayed(su, a, su.gen.get_state(), 1)
        return rep["step_ms"], rep["peak"] / 2**20
    ms_s, peak_s = _spatial_launch(one, 1)
    torch.cuda.empty_cache()
    ms_d, peak_d = one(None)
    torch.cuda.empty_cache()
    print(f"[spatial] (ak) clip_fft --size 3840-2160, 190 cutouts, one frame "
          f"group on {torch.cuda.get_device_name(0)}: device ms by replay "
          f"spatial (one NCCL rank) {ms_s:.3f}, dense {ms_d:.3f}; peak MiB "
          f"spatial {peak_s:.0f}, dense {peak_d:.0f}")


def phase_spatial(steps: int = 8):
    """(ag)-(ak): see the module docstring."""
    _spatial_clip_fft("(ag) clip_fft", "fft", [], steps)
    _spatial_clip_fft("(ah) clip_fft --dwt", "dwt", ["--dwt"], steps)
    _spatial_illustrip("(ai) illustrip --gen FFT --depth 1",
                       ["--gen", "FFT", "--depth", "1"], 8)
    _spatial_illustrip("(aj) illustrip --gen RGB", ["--gen", "RGB"], 8)
    _spatial_4k()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="kernels,main,loop,parity,mesh,spatial")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--profile-paths", default="",
                    help="comma-separated label prefixes of the paths the "
                         "profile phase takes, e.g. '(d),(e)' (default all)")
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
             "loop": lambda: (phase_loop(), phase_loop_illustra(),
                              phase_loop_illustrip(), phase_loop_coord()),
             "parity": phase_parity,
             "mesh": lambda: phase_mesh(args.steps),
             "spatial": lambda: phase_spatial(args.steps),
             "cudnn": phase_cudnn,
             "profile": lambda: phase_profile(
                 [p for p in args.profile_paths.split(",") if p])}[ph]()
            print(f"[{ph}] done in {time.time() - t:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for tmp in _TMP:
            tmp.cleanup()
    print(f"[total] {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": [report[k] for k in KERNELS if k in report]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
