"""The training step (counterpart of aphantasia_tpu.parallel.step, single
device): decode -> cutouts -> augment -> CLIP -> loss -> backward ->
optimizer update.

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
prev_enc) gated by (step_i > 0) on the device; and the spectrum-shift
noise inside the decode.  The aesthetic and sync terms are absent when
their weights (`aest_params`, `lpips_bundle`) are None, as in JAX.

The step loops (`build_train_loop`, `build_train_loop_frames`) run many
steps a dispatch, as the JAX package's scanned loops do.  Their unit is a
*group*: one step, or a frame group (one step, the uint8 render, then
`opt_step - 1` steps).  Groups work on buffers that live for the run
(`LoopBuffers`): the params and the optimizer state (adopted from the
first call and updated in place), `prev_enc`, the step index, the draws
of each of a group's steps, its loss slots and its frame slot, and the
constants of each tower (CLIP weights, aesthetic head, LPIPS bundle and
prompts) of the first call.  On the card a group's first run is eager, on
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
"""
from __future__ import annotations

import dataclasses
import time
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


@dataclasses.dataclass(frozen=True)
class StepSettings:
    """Loss/step configuration."""
    sim: str = "mix"
    sharp: float = 0.0             # finite-difference ('naiv') sharpness
    aest: float = 0.0
    enforce: float = 0.0
    expand: float = 0.0
    noise: float = 0.0
    sync: float = 0.0
    total_steps: int = 200         # the sync term's progress denominator
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
    (the DWT list), which draw no spectrum shift, as in JAX."""
    transform = get_transform(settings.transform, settings.persp)
    m = sampler.modsize

    def draw_cuts(gen):
        return CutDraws(sampler.sample_boxes(gen),
                        transform.draw(gen, sampler.count, m, m))

    def draw(gen: torch.Generator) -> StepDraws:
        shift = None
        if settings.noise > 0 and param_shape is not None:
            h, wf = param_shape[2], param_shape[3]
            shift = settings.noise * torch.rand(
                (1, 1, h, wf, 1), generator=gen, device=gen.device)
        return StepDraws(shift, draw_cuts(gen),
                         draw_cuts(gen) if settings.enforce != 0 else None)

    return draw


def build_loss_fn(parameterizer, sampler, clip_cfg, settings: StepSettings):
    """Returns loss_fn(gen_params, clip_params, aest_params, lpips_bundle,
    prompts, prev_enc, draws, step_i) -> (loss, out_enc detached), in the
    JAX loss's argument order.  `aest_params` is the aesthetic head or
    None; `lpips_bundle` is (lpips_params, half-size target image) or
    None; `prompts` a sequence of (embs [K,D], wts [K], coeff) groups;
    `step_i` an int or a 0-d int32 tensor on the params' device."""
    transform = get_transform(settings.transform, settings.persp)
    dt = settings.clip_dtype

    def encode_cuts(clip_params, cut_draws: CutDraws, img):
        cuts = sampler.cut(img, cut_draws.boxes, compute_dtype=dt)
        cuts = transform.apply(cut_draws.aug, cuts.to(dt))
        return encode_image(clip_params, clip_cfg, cuts, dtype=dt).float()

    def loss_fn(gen_params, clip_params, aest_params, lpips_bundle, prompts,
                prev_enc, draws: StepDraws, step_i):
        img = parameterizer.image(gen_params, shift=draws.shift)
        out_enc = encode_cuts(clip_params, draws.cuts, img)
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
            half = resize_bicubic(img, img_in.shape[-2:])
            loss = loss + prog * settings.sync * torch.mean(
                lpips_apply(lpips_params, half, img_in, normalize=True))
        if settings.sharp != 0:
            loss = loss - settings.sharp * derivat(img, mode="naiv")
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
                     optimizer):
    """Returns train_step(gen_params, opt_state, prev_enc, clip_params,
    aest_params, lpips_bundle, prompts, draws, step_i) -> (gen_params,
    opt_state, prev_enc, loss).  `gen_params` and `opt_state` are updated
    in place and returned."""
    loss_fn = build_loss_fn(parameterizer, sampler, clip_cfg, settings)

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
        with torch.no_grad():
            optimizer.step(gen_params, grads, opt_state)
        return gen_params, opt_state, out_enc, loss.detach()

    return train_step


def build_render(parameterizer):
    """Frame renderer: params -> [H,W,3] uint8 on the params' device."""
    @torch.no_grad()
    def render(gen_params, contrast: float = 1.0):
        img = parameterizer.image(gen_params, contrast=contrast)
        img = torch.clamp(img[0].permute(1, 2, 0), 0.0, 1.0)
        return (img * 255.0 + 0.5).to(torch.uint8)
    return render


# ---------------------------------------------------------------- step loops

def _tree_clone(tree):
    """A copy of a draw structure (named tuples of tensors, None)."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.clone()
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
    the draws; later binds copy in what differs."""

    def __init__(self, n: int, frame_shape=None):
        self.n, self.frame_shape = n, frame_shape
        self.params = None

    def bind(self, gen_params, opt_state, prev_enc, consts, draws):
        """`consts`: one (clip_params, aest_params, lpips_bundle, prompts)
        tuple per tower; `draws`: the group's n StepDraws."""
        if self.params is None:
            self.device = dev = leaves(gen_params)[0].device
            self.params, self.opt, self.prev = gen_params, opt_state, prev_enc
            self.consts = consts
            self.draws = [_tree_clone(d) for d in draws]
            self.index = torch.zeros((), dtype=torch.int32, device=dev)
            self.losses = torch.zeros((self.n,), device=dev)
            self.frame = (None if self.frame_shape is None else torch.zeros(
                self.frame_shape, dtype=torch.uint8, device=dev))
        else:
            _tree_copy((self.params, self.opt, self.prev, self.consts),
                       (gen_params, opt_state, prev_enc, consts))
            _tree_copy(self.draws, list(draws))


class StepGroup:
    """`len(towers)` train steps on the loop's buffers, step k through
    `train_steps[towers[k]]`, the frame rendered after the first when
    `render` is given.  Step k of a group sees step_i = index, or
    index + k when `stride`.  On the card the first `run` is the eager
    group and the capture (`graph`; `first_seconds` is its wall,
    synchronised before and after); later runs replay."""

    def __init__(self, train_steps, towers, stride: bool, bufs: LoopBuffers,
                 render=None, contrast: float = 1.0):
        self.train_steps, self.towers = tuple(train_steps), tuple(towers)
        self.stride, self.bufs = stride, bufs
        self.render, self.contrast = render, contrast
        self.graph = None
        self.first_seconds = None

    def run(self, index: int) -> None:
        """The group on the bound buffers, its first step at `index`."""
        b = self.bufs
        cuda = b.device.type == "cuda"
        if cuda and self.first_seconds is None:
            # the work queued before it is not this run's
            torch.cuda.synchronize(b.device)
        b.index.fill_(index)
        t0 = time.perf_counter()
        if not cuda:
            self._steps()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()
        if self.first_seconds is None:
            if cuda:
                torch.cuda.synchronize(b.device)
            self.first_seconds = time.perf_counter() - t0

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
    seconds."""

    def __init__(self, train_steps, render, opt_step: int, n_frames: int,
                 contrast: float, step_index: str, frame_shape,
                 dm_every: int | None = None):
        self.train_steps, self.render = tuple(train_steps), render
        self.opt_step, self.n_frames = opt_step, n_frames
        self.contrast, self.step_index = contrast, step_index
        self.dm_every = dm_every
        self.bufs = LoopBuffers(opt_step, tuple(frame_shape))
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
                self.train_steps, pattern, self.step_index == "global",
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
        n, nf, b = self.opt_step, self.n_frames, self.bufs
        dev = leaves(gen_params)[0].device
        frames = torch.empty((nf,) + b.frame_shape, dtype=torch.uint8,
                             device=dev)
        losses = torch.empty((nf * n,), device=dev)
        self.first_runs = {}
        for j in range(nf):
            fstep = int(frame0) + j
            base = fstep * n
            b.bind(gen_params, opt_state, prev_enc, tuple(consts),
                   [draws(base + k) for k in range(n)])
            group = self._group(self.pattern(base))
            first = group.first_seconds is None
            group.run(fstep if self.step_index == "frame" else base)
            if first:
                self.first_runs[j] = group.first_seconds
            frames[j].copy_(b.frame)
            losses[j * n:(j + 1) * n].copy_(b.losses)
            gen_params, opt_state, prev_enc = b.params, b.opt, b.prev
        return gen_params, opt_state, prev_enc, frames, losses


def build_train_loop(parameterizer, sampler, clip_cfg, settings: StepSettings,
                     optimizer, n_inner: int) -> TrainLoop:
    """`n_inner` training steps per call (the JAX package's scanned loop).

    Returns loop(gen_params, opt_state, prev_enc, clip_params, aest_params,
    lpips_bundle, prompts, draws, step0) -> (gen_params, opt_state,
    prev_enc, losses [n_inner]).  `draws(i)` gives the StepDraws of the
    call's i-th step (the JAX loop folds its key with i); the loss sees
    step_i = step0 + i.  The returned state is the loop's own buffers,
    updated in place by the next call (the JAX loop donates them)."""
    return TrainLoop(build_train_step(parameterizer, sampler, clip_cfg,
                                      settings, optimizer), n_inner)


def build_train_loop_frames(parameterizer, sampler, clip_cfg,
                            settings: StepSettings, optimizer, opt_step: int,
                            n_frames: int, contrast: float = 1.0,
                            step_index: str = "frame",
                            with_params: bool = False, dual=None) -> FrameLoop:
    """`n_frames` frame groups per call for the image CLIs.

    Each group reproduces the reference cadence: one train step, a uint8
    render of the frame, then the remaining `opt_step - 1` steps.

    Returns loop(gen_params, opt_state, prev_enc, clip_params, aest_params,
    lpips_bundle, prompts, draws, frame0) -> (gen_params, opt_state,
    prev_enc, frames [n_frames,H,W,3] uint8, losses [n_frames*opt_step]).
    `frame0` is the global frame index of the call's first group (frame k
    covers steps k*opt_step .. (k+1)*opt_step-1), and `draws(gstep)` gives
    global step gstep's StepDraws, called in step order.  `step_index`
    picks what the loss sees as step_i: the frame index (clip_fft's
    `i // opt_step`) or the global step (illustra and cppn pass `i`).  The
    returned state is the loop's own buffers, as in `build_train_loop`.

    `dual=(clip_cfg2, dm_every)` (`--dualmod`): global step g runs the
    second tower when g % dm_every == 0 and g > 0 (module docstring), and
    the loop takes (clip_params2, aest_params2, prompts2) after `prompts`,
    as the JAX loop does.  `with_params` (the frame-boundary params, for
    cppn) is not ported."""
    if with_params:
        raise NotImplementedError(
            "with_params (cppn's per-frame snapshots) is not ported to "
            "aphantasia_torch yet; see ROADMAP.md")
    if step_index not in ("frame", "global"):
        raise ValueError(f"step_index must be 'frame' or 'global', not "
                         f"{step_index!r}")
    cfgs = (clip_cfg,) if dual is None else (clip_cfg, dual[0])
    steps = [build_train_step(parameterizer, sampler, cfg, settings,
                              optimizer) for cfg in cfgs]
    return FrameLoop(steps, build_render(parameterizer), opt_step, n_frames,
                     contrast, step_index, tuple(parameterizer.size) + (3,),
                     dm_every=None if dual is None else dual[1])


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
