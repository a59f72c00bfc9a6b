"""What the per-layer readers share: a captured group's device time, the
tower's and the cut's time alone by graph replay against their bounds,
the step's share of the peak and the device's idle share.  Each reader
in benchmark/metrics returns None where it finds nothing to read."""
from __future__ import annotations

from benchmark.harness import flops, timing


def graph_step_ms(lay: dict):
    """Device ms a step of the cell's one captured group: CUDA events
    around 10 back-to-back replays, over the group's steps."""
    if len(lay.get("graphs", [])) != 1:
        return None
    graph = lay["graphs"][0]
    return timing.cuda_ms(graph.replay, iters=10, warmup=2) \
        / lay["steps_per_graph"]


def tower_roofline(lay: dict):
    """The image tower's forward and input gradient on the cell's cutout
    batch, in the cell's dtype, through `encode_image` and its autograd,
    alone by graph replay, against its bound (percent)."""
    import torch
    from aphantasia_torch.models.clip.model import encode_image
    cfg, vis, dt = lay["tower_cfg"], lay["tower_vis"], lay["dtype"]
    n, r = lay["cutouts"], cfg.image_resolution
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((n, 3, r, r), generator=gen, device="cuda").to(dt)
    co = torch.randn((n, cfg.embed_dim), generator=gen, device="cuda")

    def fn():
        xx = x.detach().requires_grad_(True)
        enc = encode_image(vis, cfg, xx, dtype=dt).float()
        return torch.autograd.grad(enc, xx, co)[0]
    ms = timing.graph_ms(fn)
    itemsize = torch.empty((), dtype=dt).element_size()
    kind = "bf16" if itemsize == 2 else "f32"
    bound = timing.bound_ms(
        flops.tower_step_bytes(lay["config"], n, itemsize),
        flops.tower_step_ops(lay["config"], n), kind)
    return 100.0 * bound / ms


def cut_roofline(lay: dict):
    """The cut's forward and backward at the cell's frame and cutout
    count (the program's sampler, the boxes of a draw), alone by graph
    replay, against the bytes it must move (percent)."""
    import torch
    sampler, dt = lay["sampler"], lay["dtype"]
    h, w = lay["size"]
    n, m = lay["cutouts"], sampler.modsize
    gen = torch.Generator(device="cuda").manual_seed(6)
    img = torch.rand((1, 3, h, w), generator=gen, device="cuda")
    co = torch.randn((n, 3, m, m), generator=gen, device="cuda")

    def fn():
        xx = img.detach().requires_grad_(True)
        cuts = sampler.cut(xx, lay["boxes"], compute_dtype=dt)
        return torch.autograd.grad(cuts, xx, co)[0]
    ms = timing.graph_ms(fn)
    bound = timing.bound_ms(flops.cut_bytes(h, w, n, m), flops.cut_ops(n, m),
                            "bf16")
    return 100.0 * bound / ms


def step_ops(lay: dict) -> float:
    """The operations a step requires: the tower's forward and input
    gradient on the cutouts, and for a VQGAN cell the decoder's forward,
    latent gradient and the frame's render."""
    ops = flops.tower_step_ops(lay["config"], lay["cutouts"])
    if "vqgan" in lay["config"]:
        h, w = lay["size"]
        ops += flops.vqgan_step_ops(lay["config"]["vqgan"], h, w)
    return ops


def step_mfu(lay: dict):
    """The window's steps times a step's operations, over the window's
    time and 989 TFLOP/s (percent)."""
    if not lay.get("steps"):
        return None
    return 100.0 * step_ops(lay) * lay["steps"] / (
        lay["window_s"] * timing.PEAK_OPS["bf16"])


def idle_share(lay: dict):
    """1 - the elapsed times of the CUDA event pairs around each dispatch
    of the traced window, over the window (percent)."""
    pairs = lay.get("pairs")
    if not pairs:
        return None
    busy_ms = sum(a.elapsed_time(b) for a, b in pairs)
    return 100.0 * (1.0 - busy_ms / (1e3 * lay["window_s"]))
