"""The training step (counterpart of aphantasia_tpu.parallel.step): decode
-> cutouts -> augment -> CLIP -> loss -> backward -> optimizer update, on
one device or over a mesh's data axis (`mesh=`, below).

Each step is a *draw* (`build_draw_fn`: the spectrum noise, the cutout
boxes and the augmentation parameters, from a torch.Generator) and an
*apply* (`build_train_step`), so a test can feed the JAX step's own draws
to this one.  PyTorch runs the step eagerly; the optimizer updates the
params and its state in place (ops/optim.py), where the JAX step donates
their buffers.  The params are a tensor (the FFT spectrum) or a list of
tensors (the DWT pyramid), updated leaf by leaf with one step count.

Loss terms (as in the JAX step, in its order): the aesthetic head
-0.001 * aest * mean(head(out_enc)); prompt groups sign * wt *
sim_func(enc, out_enc); the LPIPS sync prog * sync * mean(lpips(half-size
frame, target)) with prog = (total_steps - step_i) / total_steps read
from the device's step index; sharpness -sharp * derivat(img); enforce
-enforce * sim(out_enc, second-pass enc); expand +expand * sim(out_enc,
prev_enc) gated by (step_i > 0) on the device; the spectrum-shift noise
inside the decode; and, with `rgb_anchors` (illustrip --gen RGB), the
brightness and contrast pins |mean - 0.45| and |std - 0.17| per channel
(after the sharpness term, before enforce, as in JAX).  The aesthetic and sync terms are absent when
their weights (`aest_params`, `lpips_bundle`) are None, as in JAX.

The step loops (`build_train_loop`, `build_train_loop_frames`) run many
steps a dispatch, as the JAX package's scanned loops do.  Their unit is a
*group*: one step, or a frame group (one step, the uint8 render, then
`opt_step - 1` steps).  Groups work on buffers that live for the run
(`LoopBuffers`): the params and the optimizer state (adopted from the
first call and updated in place), `prev_enc`, the step index, the draws
of each of a group's steps, its loss slots, its frame slot and (cppn's
`with_params`) its params snapshot slot, and the constants of each tower
(CLIP weights, aesthetic head, LPIPS bundle and prompts) of the first
call.  On the card a group's first run is eager, on
a side stream, which fills every cache (the host tables, cuFFT's plans,
cuBLAS's and cuDNN's workspaces, the kernels' attributes) and whose
results stand; then the same group is captured into a CUDA graph
(`kernels.CountedGraph`; a capture runs nothing) and its later runs are
replays.  A capture that fails raises: there is no eager fallback on the
card.  On the CPU every group runs eagerly, the same operations.

The draws stay outside the graph: before each group the host makes them
from the caller's `draws(i)` in step order and copies them into the
buffers, so the random stream does not depend on how the steps are
grouped or chunked, nor on the tower, and a replay can be held to the
eager step bit for bit.  The kernels' TMA maps are encoded at capture from
the addresses of these buffers and of the graph's pool, which stay fixed,
and the environment switches are read at capture: a loop lives for one
run.

`dual=(cfg2, dm_every)` (`--dualmod`) runs global step g through the
second tower when g % dm_every == 0 and g > 0.  The schedule is static,
so where the JAX loop picks the tower with a `lax.cond` in its scan body,
the host picks the graph: a frame group's *pattern* (the tower of each of
its `opt_step` steps) depends on its first global step, each pattern that
occurs is captured once after its own eager first run, and every group
replays the graph of its pattern.  All patterns share the run's buffers.

`mesh=` (a `parallel.mesh.Mesh`) runs the step over a data axis: every
rank draws the whole batch, as one rank would, and takes its own rows of
the boxes and augmentation draws; it cuts, augments and encodes them, and
the encodings are gathered whole on every rank (`gather_rows`), so each
computes the same loss with `prev_enc` whole.  The image-side terms
(sync, sharpness, the RGB anchors) are computed whole on every rank and
count their gradient once (`replicated`), and the generator's gradients
are summed over the data axis (`reduce_grads`).  On the card the
collectives run in the eager first group, which starts NCCL's
communicator, and are captured with the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from aphantasia_torch import kernels
from aphantasia_torch.models.clip.model import encode_image
from aphantasia_torch.models.lpips import lpips_apply
from aphantasia_torch.ops.augs import get_transform
from aphantasia_torch.ops.losses import aesthetic_apply, derivat, sim_func
from aphantasia_torch.ops.optim import leaves
from aphantasia_torch.ops.resize import resize_bicubic
from aphantasia_torch.ops.sampler import Boxes
from aphantasia_torch.parallel.mesh import (gather_rows, reduce_grads,
                                            replicated, shard_batch)
from aphantasia_torch.profiling import mark, span


@dataclasses.dataclass(frozen=True)
class StepSettings:
    """Loss/step configuration."""
    sim: str = "mix"
    sharp: float = 0.0
    sharp_mode: str = "naiv"       # derivat's mode: naiv, sobel or scharr
    aest: float = 0.0
    enforce: float = 0.0
    expand: float = 0.0
    noise: float = 0.0
    noise_centered: bool = False   # the shift noise u - 0.5 (illustra)
    sync: float = 0.0
    total_steps: int = 200         # the sync term's progress denominator
    rgb_anchors: bool = False      # illustrip --gen RGB's brightness and
    #                                contrast pins
    transform: str = "fast"
    persp: str = "affine"          # the `fast` perspective: affine|mixed|exact
    clip_dtype: Any = torch.float32


class CutDraws(NamedTuple):
    """One encode pass's draws: the boxes and the transform's draws."""
    boxes: Boxes
    aug: Any


class StepDraws(NamedTuple):
    """Everything random in one step: the spectrum-shift noise
    ([1,1,h,wf,1] or None), the first cutout pass, and the second pass of
    `enforce` (or None)."""
    shift: torch.Tensor | None
    cuts: CutDraws
    cuts2: CutDraws | None


def to_device(obj, device):
    """A draw structure (named tuples of tensors) on `device`."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        vals = [to_device(v, device) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    raise TypeError(f"cannot move {type(obj)} to a device")


def _step_tensor(step_i, device) -> torch.Tensor:
    """step_i as a 0-d int32 tensor on `device` (a tensor passes as is)."""
    if isinstance(step_i, torch.Tensor):
        return step_i
    return torch.full((), step_i, dtype=torch.int32, device=device)


def build_draw_fn(sampler, settings: StepSettings, param_shape):
    """Returns draw(generator) -> StepDraws on the generator's device.
    `param_shape` is the spectrum's shape, or None for params without one
    (the DWT list), which draw no spectrum shift, as in JAX.  The shift is
    noise * u for uniform u, or noise * (u - 0.5) with `noise_centered`
    (JAX `_noise_shift`)."""
    transform = get_transform(settings.transform, settings.persp)
    m = sampler.modsize

    def draw_cuts(gen):
        return CutDraws(sampler.sample_boxes(gen),
                        transform.draw(gen, sampler.count, m, m))

    def draw(gen: torch.Generator) -> StepDraws:
        with span("draw"):
            shift = None
            if settings.noise > 0 and param_shape is not None:
                h, wf = param_shape[2], param_shape[3]
                u = torch.rand((1, 1, h, wf, 1), generator=gen,
                               device=gen.device)
                if settings.noise_centered:
                    u = u - 0.5
                shift = settings.noise * u
            return StepDraws(shift, draw_cuts(gen),
                             draw_cuts(gen) if settings.enforce != 0 else None)

    return draw


def build_loss_fn(parameterizer, sampler, clip_cfg, settings: StepSettings,
                  mesh=None):
    """Returns loss_fn(gen_params, clip_params, aest_params, lpips_bundle,
    prompts, prev_enc, draws, step_i) -> (loss, out_enc detached), in the
    JAX loss's argument order.  `aest_params` is the aesthetic head or
    None; `lpips_bundle` is (lpips_params, half-size target image) or
    None; `prompts` a sequence of (embs [K,D], wts [K], coeff) groups;
    `step_i` an int or a 0-d int32 tensor on the params' device.  With
    `mesh` the cutouts split over its data axis (module docstring).

    Without `mesh` the layers are marked for a captured graph's device
    times (`profiling.mark`, `CountedGraph.layer_ms`): "decode" on the
    params, "cut" on the frame, "tower" on the augmented cutouts and
    "loss" on their encodings, each before the layer it names (the cut's
    interval holds the augment); the backward marks each layer's end."""
    transform = get_transform(settings.transform, settings.persp)
    dt = settings.clip_dtype
    n = sampler.count
    local = sampler
    marked = mark
    if mesh is not None:
        rows = mesh.rows(n)
        local = dataclasses.replace(sampler, count=rows.stop - rows.start)
        marked = _unmarked

    def encode_cuts(clip_params, cut_draws: CutDraws, img):
        if mesh is not None:
            cut_draws = shard_batch(cut_draws, mesh, n)
        cuts = local.cut(marked(img, "cut"), cut_draws.boxes,
                         compute_dtype=dt)
        cuts = transform.apply(cut_draws.aug, cuts.to(dt))
        enc = encode_image(clip_params, clip_cfg, marked(cuts, "tower"),
                           dtype=dt).float()
        return (marked(enc, "loss") if mesh is None
                else gather_rows(enc, mesh, n))

    def loss_fn(gen_params, clip_params, aest_params, lpips_bundle, prompts,
                prev_enc, draws: StepDraws, step_i):
        img = parameterizer.image(marked(gen_params, "decode"),
                                  shift=draws.shift)
        out_enc = encode_cuts(clip_params, draws.cuts, img)
        img_r = replicated(img, mesh)     # the image-side terms' input
        loss = torch.zeros((), device=img.device)
        if settings.aest != 0 and aest_params is not None:
            loss = loss - 0.001 * settings.aest * torch.mean(
                aesthetic_apply(aest_params, out_enc))
        for embs, wts, coeff in prompts:
            group = torch.zeros((), device=img.device)
            for j in range(embs.shape[0]):
                group = group + wts[j] * sim_func(embs[j:j + 1], out_enc,
                                                  settings.sim)
            loss = loss + coeff * group
        if settings.sync > 0 and lpips_bundle is not None:
            lpips_params, img_in = lpips_bundle
            # the step index is read on the device: a captured step reads
            # it at each replay
            si = _step_tensor(step_i, img.device)
            total = torch.full((), settings.total_steps, dtype=torch.int32,
                               device=img.device)
            prog = (total - si).float() / total.float()
            half = resize_bicubic(img_r, img_in.shape[-2:])
            loss = loss + prog * settings.sync * torch.mean(
                lpips_apply(lpips_params, half, img_in, normalize=True))
        if settings.sharp != 0:
            loss = loss - settings.sharp * derivat(img_r,
                                                   mode=settings.sharp_mode)
        if settings.rgb_anchors:
            loss = loss + torch.mean(torch.abs(img_r.mean(dim=(2, 3)) - 0.45))
            loss = loss + torch.mean(torch.abs(img_r.std(dim=(2, 3)) - 0.17))
        if settings.enforce != 0:
            enc2 = encode_cuts(clip_params, draws.cuts2, img)
            loss = loss - settings.enforce * sim_func(out_enc, enc2,
                                                      settings.sim)
        if settings.expand > 0:
            gate = (_step_tensor(step_i, img.device) > 0).float()
            loss = loss + gate * settings.expand * sim_func(out_enc, prev_enc,
                                                            settings.sim)
        return loss, out_enc.detach()

    return loss_fn


def build_train_step(parameterizer, sampler, clip_cfg, settings: StepSettings,
                     optimizer, mesh=None):
    """Returns train_step(gen_params, opt_state, prev_enc, clip_params,
    aest_params, lpips_bundle, prompts, draws, step_i) -> (gen_params,
    opt_state, prev_enc, loss).  `gen_params` and `opt_state` are updated
    in place and returned.  With `mesh` the gradients are summed over its
    data axis before the update."""
    loss_fn = build_loss_fn(parameterizer, sampler, clip_cfg, settings, mesh)

    def train_step(gen_params, opt_state, prev_enc, clip_params, aest_params,
                   lpips_bundle, prompts, draws: StepDraws, step_i):
        ps = leaves(gen_params)
        for p in ps:
            p.requires_grad_(True)
        loss, out_enc = loss_fn(gen_params, clip_params, aest_params,
                                lpips_bundle, prompts, prev_enc, draws,
                                step_i)
        grads = torch.autograd.grad(loss, ps)
        for p in ps:
            p.requires_grad_(False)
        if mesh is not None:
            reduce_grads(grads, mesh)
        with torch.no_grad():
            optimizer.step(gen_params, grads, opt_state)
        return gen_params, opt_state, out_enc, loss.detach()

    return train_step


def _unmarked(x, name):
    return x


def build_render(parameterizer):
    """Frame renderer: params -> [H,W,3] uint8 on the params' device,
    marked "render" and, after it, "group" (the loop's own work) for a
    captured graph's device times."""
    @torch.no_grad()
    def render(gen_params, contrast: float = 1.0):
        img = parameterizer.image(mark(gen_params, "render"),
                                  contrast=contrast)
        img = torch.clamp(img[0].permute(1, 2, 0), 0.0, 1.0)
        return mark((img * 255.0 + 0.5).to(torch.uint8), "group")
    return render


# ---------------------------------------------------------------- step loops

def _tree_clone(tree):
    """A copy of a draw structure (named tuples or dicts of tensors,
    None)."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.clone()
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    vals = [_tree_clone(v) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def _tree_copy(dst, src):
    """Copy `src` into the like-shaped `dst` in place: tensors by `copy_`
    (skipped where both are one tensor), anything else must be equal (a
    captured group holds it as a constant)."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError("a loop's structures cannot change between calls")
        for k in dst:
            _tree_copy(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, v in zip(dst, src, strict=True):
            _tree_copy(d, v)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _tree_copy(getattr(dst, f.name), getattr(src, f.name))
    elif dst is not src and (dst is None or src is None or dst != src):
        raise ValueError(f"a loop's constant changed: {dst!r} -> {src!r}")


class LoopBuffers:
    """The run's buffers (module docstring), shared by every group of a
    loop: the first `bind` adopts the state and the constants and clones
    the draws; later binds copy in what differs.  With `with_params`,
    `snap` holds a copy of each params tensor, which a group fills at its
    render point."""

    def __init__(self, n: int, frame_shape=None, with_params: bool = False):
        self.n, self.frame_shape = n, frame_shape
        self.with_params = with_params
        self.params = self.snap = None

    def bind(self, gen_params, opt_state, prev_enc, consts, draws,
             extra=None):
        """`consts`: one (clip_params, aest_params, lpips_bundle, prompts)
        tuple per tower; `draws`: the group's n StepDraws; `extra`: a dict
        of further input tensors (a video frame's motion scalars and depth
        map), cloned like the draws."""
        if self.params is None:
            self.extra = _tree_clone(extra)
            self.device = dev = leaves(gen_params)[0].device
            self.params, self.opt, self.prev = gen_params, opt_state, prev_enc
            self.consts = consts
            self.draws = [_tree_clone(d) for d in draws]
            self.index = torch.zeros((), dtype=torch.int32, device=dev)
            self.losses = torch.zeros((self.n,), device=dev)
            self.frame = (None if self.frame_shape is None else torch.zeros(
                self.frame_shape, dtype=torch.uint8, device=dev))
            if self.with_params:
                self.snap = [torch.empty_like(p) for p in leaves(gen_params)]
        else:
            _tree_copy((self.params, self.opt, self.prev, self.consts),
                       (gen_params, opt_state, prev_enc, consts))
            _tree_copy(self.draws, list(draws))
            _tree_copy(self.extra, extra)


class StepGroup:
    """`len(towers)` train steps on the loop's buffers, step k through
    `train_steps[towers[k]]`, the frame rendered after the first when
    `render` is given.  Step k of a group sees step_i = index, or
    index + k when `stride`.  On the card the first `run` is the eager
    group and the capture (`graph`); later runs replay.  A run is a span
    "loop.group"; the first run's eager group and capture (on the CPU its
    eager group), synchronised before and after, a span "loop.capture",
    whose length is `first_seconds`."""

    CAPTURE_SPAN = "loop.capture"

    def __init__(self, train_steps, towers, stride: bool, bufs: LoopBuffers,
                 render=None, contrast: float = 1.0):
        self.train_steps, self.towers = tuple(train_steps), tuple(towers)
        self.stride, self.bufs = stride, bufs
        self.render, self.contrast = render, contrast
        self.graph = None
        self.first_seconds = None

    def run(self, index: int) -> None:
        """The group on the bound buffers, its first step at `index`."""
        with span("loop.group"):
            self._run(index)

    def _run(self, index: int) -> None:
        b = self.bufs
        cuda = b.device.type == "cuda"
        if self.first_seconds is None:
            if cuda:
                # the work queued before it is not this run's
                torch.cuda.synchronize(b.device)
            b.index.fill_(index)
            with span(self.CAPTURE_SPAN) as first:
                if cuda:
                    self._capture()
                    torch.cuda.synchronize(b.device)
                else:
                    self._steps()
            self.first_seconds = first.seconds
            return
        b.index.fill_(index)
        if cuda:
            self.graph.replay()
        else:
            self._steps()

    def _steps(self) -> None:
        b = self.bufs
        for k, tower in enumerate(self.towers):
            si = b.index + k if k and self.stride else b.index
            _, _, out_enc, loss = self.train_steps[tower](
                b.params, b.opt, b.prev, *b.consts[tower], b.draws[k], si)
            b.prev.copy_(out_enc)
            b.losses[k].copy_(loss)
            if k == 0 and self.render is not None:
                b.frame.copy_(self.render(b.params, contrast=self.contrast))
                if b.snap is not None:
                    for d, p in zip(b.snap, leaves(b.params), strict=True):
                        d.copy_(p)

    def _capture(self) -> None:
        """The eager group on a side stream (PyTorch captures autograd
        only after such a warm-up), then the same group captured."""
        dev = self.bufs.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._steps()
        main.wait_stream(side)
        graph = kernels.CountedGraph()
        # thread_local: the frame writer's threads may wait on a CUDA event
        # meanwhile, which a global-mode capture would refuse
        with graph.capture(capture_error_mode="thread_local"):
            self._steps()
        self.graph = graph


class TrainLoop:
    """`build_train_loop`'s loop: `n_inner` one-step groups a call."""

    def __init__(self, train_step, n_inner: int):
        self.n_inner = n_inner
        self.group = StepGroup((train_step,), (0,), False, LoopBuffers(1))

    def __call__(self, gen_params, opt_state, prev_enc, clip_params,
                 aest_params, lpips_bundle, prompts,
                 draws: Callable[[int], StepDraws], step0: int):
        b = self.group.bufs
        consts = ((clip_params, aest_params, lpips_bundle, prompts),)
        losses = torch.empty((self.n_inner,),
                             device=leaves(gen_params)[0].device)
        for i in range(self.n_inner):
            b.bind(gen_params, opt_state, prev_enc, consts, [draws(i)])
            self.group.run(int(step0) + i)
            losses[i].copy_(b.losses[0])
            gen_params, opt_state, prev_enc = b.params, b.opt, b.prev
        return gen_params, opt_state, prev_enc, losses


class FrameLoop:
    """`build_train_loop_frames`'s loop: `n_frames` frame groups a call,
    each through the StepGroup of its tower pattern (one pattern without
    `dm_every`).  `first_runs` maps the index in the last call of each
    group that ran its pattern's eager group and capture to that run's
    seconds.  With `with_params` a call also returns each group's params
    snapshot, stacked."""

    def __init__(self, train_steps, render, opt_step: int, n_frames: int,
                 contrast: float, step_index: str, frame_shape,
                 dm_every: int | None = None, with_params: bool = False):
        self.train_steps, self.render = tuple(train_steps), render
        self.opt_step, self.n_frames = opt_step, n_frames
        self.contrast, self.step_index = contrast, step_index
        self.dm_every = dm_every
        self.bufs = LoopBuffers(opt_step, tuple(frame_shape), with_params)
        self.groups: dict = {}
        self.first_runs: dict = {}

    def pattern(self, base: int) -> tuple:
        """The tower of each step of the group whose first global step is
        `base`: 1 where g % dm_every == 0 and g > 0."""
        dm = self.dm_every
        return tuple(int(dm is not None and g % dm == 0 and g > 0)
                     for g in range(base, base + self.opt_step))

    def _group(self, pattern) -> StepGroup:
        if pattern not in self.groups:
            self.groups[pattern] = StepGroup(
                self.train_steps, pattern, self.step_index != "frame",
                self.bufs, self.render, self.contrast)
        return self.groups[pattern]

    def __call__(self, gen_params, opt_state, prev_enc, clip_params,
                 aest_params, lpips_bundle, prompts, *rest):
        consts = [(clip_params, aest_params, lpips_bundle, prompts)]
        if self.dm_every is not None:
            clip_params2, aest_params2, prompts2, draws, frame0 = rest
            consts.append((clip_params2, aest_params2, lpips_bundle,
                           prompts2))
        else:
            draws, frame0 = rest
        with span("loop.dispatch"):
            return self._dispatch(gen_params, opt_state, prev_enc,
                                  tuple(consts), draws, frame0)

    def _dispatch(self, gen_params, opt_state, prev_enc, consts, draws,
                  frame0):
        n, nf, b = self.opt_step, self.n_frames, self.bufs
        dev = leaves(gen_params)[0].device
        frames = torch.empty((nf,) + b.frame_shape, dtype=torch.uint8,
                             device=dev)
        losses = torch.empty((nf * n,), device=dev)
        snaps = ([torch.empty((nf,) + tuple(p.shape), dtype=p.dtype,
                              device=dev) for p in leaves(gen_params)]
                 if b.with_params else None)
        self.first_runs = {}
        for j in range(nf):
            fstep = int(frame0) + j
            base = fstep * n
            b.bind(gen_params, opt_state, prev_enc, consts,
                   [draws(base + k) for k in range(n)])
            group = self._group(self.pattern(base))
            first = group.first_seconds is None
            group.run(fstep if self.step_index == "frame" else base)
            if first:
                self.first_runs[j] = group.first_seconds
            frames[j].copy_(b.frame)
            losses[j * n:(j + 1) * n].copy_(b.losses)
            if snaps is not None:
                for d, s in zip(snaps, b.snap, strict=True):
                    d[j].copy_(s)
            gen_params, opt_state, prev_enc = b.params, b.opt, b.prev
        if snaps is not None:
            if not isinstance(gen_params, (list, tuple)):
                snaps = snaps[0]
            return gen_params, opt_state, prev_enc, frames, snaps, losses
        return gen_params, opt_state, prev_enc, frames, losses


def build_train_loop(parameterizer, sampler, clip_cfg, settings: StepSettings,
                     optimizer, n_inner: int, mesh=None) -> TrainLoop:
    """`n_inner` training steps per call (the JAX package's scanned loop).

    Returns loop(gen_params, opt_state, prev_enc, clip_params, aest_params,
    lpips_bundle, prompts, draws, step0) -> (gen_params, opt_state,
    prev_enc, losses [n_inner]).  `draws(i)` gives the StepDraws of the
    call's i-th step (the JAX loop folds its key with i); the loss sees
    step_i = step0 + i.  The returned state is the loop's own buffers,
    updated in place by the next call (the JAX loop donates them)."""
    return TrainLoop(build_train_step(parameterizer, sampler, clip_cfg,
                                      settings, optimizer, mesh), n_inner)


def build_train_loop_frames(parameterizer, sampler, clip_cfg,
                            settings: StepSettings, optimizer, opt_step: int,
                            n_frames: int, contrast: float = 1.0,
                            step_index: str = "frame",
                            with_params: bool = False, dual=None,
                            mesh=None) -> FrameLoop:
    """`n_frames` frame groups per call for the image CLIs.

    Each group reproduces the reference cadence: one train step, a uint8
    render of the frame, then the remaining `opt_step - 1` steps.

    Returns loop(gen_params, opt_state, prev_enc, clip_params, aest_params,
    lpips_bundle, prompts, draws, frame0) -> (gen_params, opt_state,
    prev_enc, frames [n_frames,H,W,3] uint8, losses [n_frames*opt_step]).
    `frame0` is the global frame index of the call's first group (frame k
    covers steps k*opt_step .. (k+1)*opt_step-1), and `draws(gstep)` gives
    global step gstep's StepDraws, called in step order.  `step_index`
    picks what the loss sees as step_i: "frame", the frame index
    (clip_fft's `i // opt_step`), or "step" (the JAX name; "global" is
    the same), the global step (illustra and cppn pass `i`).  The returned
    state is the loop's own buffers, as in `build_train_loop`.

    `dual=(clip_cfg2, dm_every)` (`--dualmod`): global step g runs the
    second tower when g % dm_every == 0 and g > 0 (module docstring), and
    the loop takes (clip_params2, aest_params2, prompts2) after `prompts`,
    as the JAX loop does.

    `with_params=True` (cppn's per-frame `.npy` snapshots) returns, after
    the frames, each group's params at its render point (after its first
    step, as the frame), stacked: (gen_params, opt_state, prev_enc,
    frames, snaps, losses), `snaps` a tensor [n_frames, ...] or, for list
    params, a list of them in the params' order.  A group copies its
    params into a slot of the loop's buffers (on the card inside its
    graph, so the next replay does not overwrite them), and the call
    gathers the slots as it gathers the frames."""
    if step_index not in ("frame", "step", "global"):
        raise ValueError(f"step_index must be 'frame' or 'step' ('global'), "
                         f"not {step_index!r}")
    cfgs = (clip_cfg,) if dual is None else (clip_cfg, dual[0])
    steps = [build_train_step(parameterizer, sampler, cfg, settings,
                              optimizer, mesh) for cfg in cfgs]
    return FrameLoop(steps, build_render(parameterizer), opt_step, n_frames,
                     contrast, step_index, tuple(parameterizer.size) + (3,),
                     dm_every=None if dual is None else dual[1],
                     with_params=with_params)


def build_shift_render_loop(parameterizer, contrast: float = 1.0):
    """The spectrum crossfade of interpol and illustra's final assembly:
    loop(params, diff, xs) -> the uint8 frames [N,H,W,3] of
    decode(params + xs[i] * diff), i < N = len(xs), clamped and rounded as
    `build_render` does.  The N frames decode as one batch (each frame
    normalised by its own std, as the JAX loop's per-frame scan does), so
    the card makes one pass and one pull for them."""
    @torch.no_grad()
    def loop(params, diff, xs):
        xs = torch.as_tensor(xs, dtype=torch.float32, device=params.device)
        shift = diff * xs.reshape(-1, 1, 1, 1, 1)          # [N,3,H,Wf,2]
        img = parameterizer.image(params, shift=shift, contrast=contrast)
        img = torch.clamp(img.permute(0, 2, 3, 1), 0.0, 1.0)
        return (img * 255.0 + 0.5).to(torch.uint8)
    return loop


def frames_per_dispatch(size, n_frames_total: int,
                        cap_bytes: int = 75_000_000) -> int:
    """Largest divisor of `n_frames_total` whose stacked uint8 frames stay
    under `cap_bytes` (and <= 16): frame chunks trade dispatch overhead
    against render-buffer memory and transfer."""
    per = size[0] * size[1] * 3
    cap = max(1, min(16, cap_bytes // max(per, 1)))
    best = 1
    for f in range(1, cap + 1):
        if n_frames_total % f == 0:
            best = f
    return best


# ---------------------------------------------------------------- video frames

class FrameGroup(StepGroup):
    """One illustrip frame on its buffers (`FrameStep`): the motion warp of
    the params, a fresh optimizer state unless `smooth`, `opt_steps` train
    steps that all see the frame's step index, the uint8 render after the
    last, and with depth the next depth preview (`preview`, allocated
    before the first run).  A run is inside its frame's "frame.step" span;
    the first run's eager group and capture is a span "frame.capture"."""

    CAPTURE_SPAN = "frame.capture"

    def __init__(self, frame_step, train_step, bufs: LoopBuffers):
        super().__init__((train_step,), (0,) * frame_step.opt_steps, False,
                         bufs)
        self.fs = frame_step
        self.preview = None

    def run(self, index: int) -> None:
        self._run(index)

    def _steps(self) -> None:
        b, fs = self.bufs, self.fs
        with torch.no_grad():
            b.params.copy_(fs.motion_warp(b.params, b.extra["motion"],
                                          b.extra.get("depth")))
            if not fs.smooth:
                fs.optimizer.reset(b.opt)
        for k in range(fs.opt_steps):
            _, _, out_enc, loss = self.train_steps[0](
                b.params, b.opt, b.prev, *b.consts[0], b.draws[k], b.index)
            b.prev.copy_(out_enc)
            b.losses[k].copy_(loss)
        b.frame.copy_(fs.render(b.params, contrast=fs.contrast))
        if fs.with_depth:
            with torch.no_grad():
                self.preview.copy_(fs.preview(b.params))


class FrameStep:
    """`build_frame_step`'s frame function.  Frames whose prompts have the
    same shapes share one `FrameGroup` and its buffers (on the card one
    CUDA graph); prompts of other shapes (a scene line with another number
    of `|` parts) get a group of their own, which adopts the same params,
    optimizer state and prev_enc, so both graphs work on one state."""

    def __init__(self, parameterizer, sampler, clip_cfg, settings, optimizer,
                 gen: str, size, opt_steps: int, smooth: bool,
                 contrast: float, deptha, depth: float, colors: float,
                 mesh=None, train_step=None, render=None):
        self.par, self.optimizer = parameterizer, optimizer
        self.gen, self.size = gen, tuple(size)
        self.opt_steps, self.smooth, self.contrast = opt_steps, smooth, contrast
        self.depth, self.colors = depth, colors
        # the JAX gate: zero or negative strength disables the warp
        self.with_depth = deptha is not None and depth > 0.0
        self.train_step = train_step or build_train_step(
            parameterizer, sampler, clip_cfg, settings, optimizer, mesh)
        self.render = render or build_render(parameterizer)
        self.groups: dict = {}

    def decode_raw(self, params):
        """The frame state in image space: the spectrum's ortho irfft2, or
        the pixels themselves."""
        from aphantasia_torch.params.fft import spectrum_to_image
        return (spectrum_to_image(params, self.size) if self.gen == "FFT"
                else params)

    def motion_warp(self, params, motion, depth_map=None):
        """The frame's motion on the params: decode, `warp_frame` and, for
        FFT, the spectrum again."""
        from aphantasia_torch.params.fft import image_to_spectrum
        img = self.warp_frame(self.decode_raw(params), motion, depth_map)
        return (image_to_spectrum(img, self.size) if self.gen == "FFT"
                else img)

    def warp_frame(self, img, motion, depth_map=None):
        """The frame's motion on its image [1,3,H,W]: the depth warp (with
        depth), then `frame_transform`.  `motion` is the [5] float32
        tensor (angle, shift x, shift y, scale, shear); the warp origin
        dx = 100 sh0 / w, dy = 100 sh1 / h, dz = 0.5 + 32 (scale - 1) is
        computed on its device."""
        from aphantasia_torch.ops.warp import frame_transform
        h, w = self.size
        angle, sh0, sh1, scale, shear = motion.unbind(0)
        if self.with_depth:
            from aphantasia_torch.motion.depthwarp import grid_warp
            # true divisions on every device (a CUDA tensor divided by a
            # Python scalar is multiplied by its reciprocal)
            dx = 100.0 * sh0 / torch.full_like(sh0, w)
            dy = 100.0 * sh1 / torch.full_like(sh1, h)
            dz = 0.5 + 32.0 * (scale - 1.0)
            d = resize_bicubic(depth_map, (h, w))
            img = grid_warp(img, d[0], self.depth, (dx, dy), dz)
        return frame_transform(img, (h, w), angle, (sh0, sh1), scale, shear)

    def preview(self, params):
        """The depth preview of the frame state (`_depth_preview`)."""
        return _depth_preview(self.decode_raw(params), self.size, self.colors)

    def __call__(self, params_tmp, opt_state, prev_enc, clip_params,
                 aest_params, prompts, draws, step_i, motion, depth_map=None):
        with span("frame.step"):
            return self._frame(params_tmp, opt_state, prev_enc, clip_params,
                               aest_params, prompts, draws, step_i, motion,
                               depth_map)

    def _frame(self, params_tmp, opt_state, prev_enc, clip_params,
               aest_params, prompts, draws, step_i, motion, depth_map):
        key = tuple(tuple(tuple(t.shape) for t in g[:2]) for g in prompts)
        group = self.groups.get(key)
        if group is None:
            bufs = LoopBuffers(self.opt_steps, tuple(self.size) + (3,))
            group = self.groups[key] = FrameGroup(self, self.train_step, bufs)
        dev = leaves(params_tmp)[0].device
        mot = torch.stack([v.float() if isinstance(v, torch.Tensor)
                           else torch.full((), float(v), device=dev)
                           for v in motion])
        extra = {"motion": mot}
        if self.with_depth:
            extra["depth"] = depth_map
        b = group.bufs
        b.bind(params_tmp, opt_state, prev_enc,
               ((clip_params, aest_params, None, tuple(prompts)),),
               list(draws), extra)
        if self.with_depth and group.preview is None:
            from aphantasia_torch.motion.depthwarp import depth_dims
            group.preview = torch.zeros((1, 3) + depth_dims(self.size),
                                        device=dev)
        group.run(int(step_i))
        out = (b.params, b.opt, b.prev, b.frame.clone(), b.losses.clone())
        if self.with_depth:
            out += (group.preview.clone(),)
        return out


def build_frame_step(parameterizer, sampler, clip_cfg, settings: StepSettings,
                     optimizer, gen: str, size, opt_steps: int, smooth: bool,
                     contrast: float = 1.0, deptha=None, depth: float = 0.0,
                     colors: float = 1.0, mesh=None) -> FrameStep:
    """One illustrip video frame a call (JAX `build_frame_step`).

    Returns frame_fn(params_tmp, opt_state, prev_enc, clip_params,
    aest_params, prompts, draws, step_i, motion[, depth_map]) ->
    (params_tmp, opt_state, prev_enc, frame_u8 [H,W,3], losses
    [opt_steps][, preview]).  `draws` are the frame's `opt_steps`
    StepDraws (the JAX frame folds its key with the step s); every step
    sees `step_i`, the frame's index in its scene; `motion` = (angle_deg,
    shift_x, shift_y, scale, shear_deg), floats or 0-d tensors.  A frame:
    the motion warp (RGB: `frame_transform` on the params; FFT: decode,
    warp, re-encode), a fresh optimizer state (zeroed in place) or with
    `smooth` the carried one, the steps, and the render after the last
    step.  With depth (`deptha` and `depth` > 0) the frame takes the
    mirror-fused depth map at the DA-V2 inference size, warps the frame
    by it (`grid_warp`, before `frame_transform`) and returns the preview
    of its raw state after the steps, for the next depth forward
    (`build_depth_helpers`).  The returned state is the frame group's own
    buffers, updated in place by the next call; the frame, the losses and
    the preview are copies.  On the card a group's first frame runs
    eagerly and is captured, later frames replay (module docstring)."""
    return FrameStep(parameterizer, sampler, clip_cfg, settings, optimizer,
                     gen, size, opt_steps, smooth, contrast, deptha, depth,
                     colors, mesh)


def _depth_preview(img_raw, size, colors):
    """The DA-V2-sized preview (motion/depthwarp.py:depth_preview) of the
    frame's raw (before the color head's std normalisation) state."""
    from aphantasia_torch.motion.depthwarp import depth_preview
    from aphantasia_torch.params.color import to_valid_rgb
    return depth_preview(to_valid_rgb(img_raw, colors=colors), size)


class GraphFn:
    """fn(x) with no gradient at one input shape.  On the card its first
    call runs eagerly on a side stream (that result is returned) and is
    then captured into a `kernels.CountedGraph` (a span "loop.capture",
    whose length is `first_seconds`); later calls copy x into the graph's
    input and replay, and return the graph's output, which the next call
    overwrites.  On the CPU every call runs eagerly."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = self.x = self.out = None
        self.first_seconds = None

    @torch.no_grad()
    def __call__(self, x):
        if x.device.type != "cuda":
            return self.fn(x)
        if self.graph is not None:
            self.x.copy_(x)
            self.graph.replay()
            return self.out
        torch.cuda.synchronize(x.device)
        with span("loop.capture") as capture:
            self.x = x.clone()
            main = torch.cuda.current_stream(x.device)
            side = torch.cuda.Stream(x.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                first = self.fn(self.x)
            main.wait_stream(side)
            graph = kernels.CountedGraph()
            with graph.capture(capture_error_mode="thread_local"):
                self.out = self.fn(self.x)
            self.graph = graph
            torch.cuda.synchronize(x.device)
        self.first_seconds = capture.seconds
        return first


class DepthHelpers(NamedTuple):
    """`build_depth_helpers`' pair: `preview(params)`, the frame-0
    bootstrap, and `infer(preview)`, the mirror-fused depth map."""
    preview: Callable
    infer: GraphFn


def build_depth_helpers(gen: str, size, deptha, colors: float) -> DepthHelpers:
    """The host-side companions of `build_frame_step`'s depth mode:
    `preview(params)` gives the first frame's preview (later frames reuse
    the one the frame returns); `infer(preview)` runs ONE batched DA-V2
    forward of the preview and its mirror and returns their fused product
    `d * flip(d_mirror)` [1,1,hd,wd] (`mirror_fused_depth`), on the card
    as a CUDA graph of its own at the fixed preview shape."""
    from aphantasia_torch.motion.depthwarp import mirror_fused_depth
    from aphantasia_torch.params.fft import spectrum_to_image
    h, w = size

    @torch.no_grad()
    def preview(params_tmp):
        img = (spectrum_to_image(params_tmp, (h, w)) if gen == "FFT"
               else params_tmp)
        return _depth_preview(img, (h, w), colors)

    return DepthHelpers(preview, GraphFn(
        lambda x: mirror_fused_depth(deptha, x)))
