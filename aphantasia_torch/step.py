"""The training step (counterpart of aphantasia_tpu.parallel.step, single
device): decode -> cutouts -> augment -> CLIP -> loss -> backward ->
optimizer update.

Each step is a *draw* (`build_draw_fn`: the spectrum noise, the cutout
boxes and the augmentation parameters, from a torch.Generator) and an
*apply* (`build_train_step`), so a test can feed the JAX step's own draws
to this one.  PyTorch runs the step eagerly; the optimizer updates the
params and its state in place (ops/optim.py), where the JAX step donates
their buffers.

Loss terms (as in the JAX step): prompt groups sign * wt * sim_func(enc,
out_enc), sharpness -sharp * derivat(img), enforce -enforce * sim(out_enc,
second-pass enc), expand +expand * sim(out_enc, prev_enc) from step 1 on,
and the spectrum-shift noise inside the decode.  The aesthetic and
LPIPS-sync terms raise until their models are ported (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from aphantasia_torch.models.clip.model import encode_image
from aphantasia_torch.ops.augs import get_transform
from aphantasia_torch.ops.losses import derivat, sim_func
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


def _check_ported(settings: StepSettings):
    if settings.aest != 0:
        raise NotImplementedError(
            "the aesthetic loss (--aest) is not ported to aphantasia_torch "
            "yet; see ROADMAP.md")
    if settings.sync > 0:
        raise NotImplementedError(
            "the LPIPS sync loss (--sync) is not ported to aphantasia_torch "
            "yet; see ROADMAP.md")


def build_draw_fn(sampler, settings: StepSettings, param_shape):
    """Returns draw(generator) -> StepDraws on the generator's device."""
    transform = get_transform(settings.transform, settings.persp)
    m = sampler.modsize

    def draw_cuts(gen):
        return CutDraws(sampler.sample_boxes(gen),
                        transform.draw(gen, sampler.count, m, m))

    def draw(gen: torch.Generator) -> StepDraws:
        shift = None
        if settings.noise > 0:
            h, wf = param_shape[2], param_shape[3]
            shift = settings.noise * torch.rand(
                (1, 1, h, wf, 1), generator=gen, device=gen.device)
        return StepDraws(shift, draw_cuts(gen),
                         draw_cuts(gen) if settings.enforce != 0 else None)

    return draw


def build_loss_fn(parameterizer, sampler, clip_cfg, settings: StepSettings):
    """Returns loss_fn(gen_params, clip_params, prompts, prev_enc, draws,
    step_i) -> (loss, out_enc detached).  `prompts` is a sequence of
    (embs [K,D], wts [K], coeff) groups."""
    _check_ported(settings)
    transform = get_transform(settings.transform, settings.persp)
    dt = settings.clip_dtype

    def encode_cuts(clip_params, cut_draws: CutDraws, img):
        cuts = sampler.cut(img, cut_draws.boxes, compute_dtype=dt)
        cuts = transform.apply(cut_draws.aug, cuts.to(dt))
        return encode_image(clip_params, clip_cfg, cuts, dtype=dt).float()

    def loss_fn(gen_params, clip_params, prompts, prev_enc,
                draws: StepDraws, step_i: int):
        img = parameterizer.image(gen_params, shift=draws.shift)
        out_enc = encode_cuts(clip_params, draws.cuts, img)
        loss = torch.zeros((), device=img.device)
        for embs, wts, coeff in prompts:
            group = torch.zeros((), device=img.device)
            for j in range(embs.shape[0]):
                group = group + wts[j] * sim_func(embs[j:j + 1], out_enc,
                                                  settings.sim)
            loss = loss + coeff * group
        if settings.sharp != 0:
            loss = loss - settings.sharp * derivat(img, mode="naiv")
        if settings.enforce != 0:
            enc2 = encode_cuts(clip_params, draws.cuts2, img)
            loss = loss - settings.enforce * sim_func(out_enc, enc2,
                                                      settings.sim)
        if settings.expand > 0 and step_i > 0:
            loss = loss + settings.expand * sim_func(out_enc, prev_enc,
                                                     settings.sim)
        return loss, out_enc.detach()

    return loss_fn


def build_train_step(parameterizer, sampler, clip_cfg, settings: StepSettings,
                     optimizer):
    """Returns train_step(gen_params, opt_state, prev_enc, clip_params,
    prompts, draws, step_i) -> (gen_params, opt_state, prev_enc, loss).
    `gen_params` and `opt_state` are updated in place and returned."""
    loss_fn = build_loss_fn(parameterizer, sampler, clip_cfg, settings)

    def train_step(gen_params, opt_state, prev_enc, clip_params, prompts,
                   draws: StepDraws, step_i: int):
        gen_params.requires_grad_(True)
        loss, out_enc = loss_fn(gen_params, clip_params, prompts, prev_enc,
                                draws, step_i)
        (grads,) = torch.autograd.grad(loss, gen_params)
        gen_params.requires_grad_(False)
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
