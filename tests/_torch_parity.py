"""Shared helpers of the tests/test_torch_*.py parity tests: the JAX
package's random draws, made from its keys exactly as its step and
pipelines split them, converted to the port's draw structures."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from aphantasia_torch.ops.augs import ErasingDraws, FastDraws
from aphantasia_torch.ops.sampler import Boxes
from aphantasia_torch.step import CutDraws, StepDraws


def t(x, dtype=None):
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def jax_fast_draws(key, s, h, w) -> FastDraws:
    """The draws of aphantasia_tpu.ops.augs.transforms_fast_affine(key)."""
    from aphantasia_tpu.ops.augs import _ROT_ANGLES
    from aphantasia_tpu.ops.perspective import perspective_endpoints
    k1, k2, k3 = jax.random.split(key, 3)
    _, end = perspective_endpoints(k1, s, h, w, distortion=0.33, p=0.2)
    rot = jax.random.randint(k2, (s,), 0, len(_ROT_ANGLES))
    ks = jax.random.split(k3, 5)
    er = ErasingDraws(
        t(jax.random.uniform(ks[0], (s,)) < 0.2),
        t(jax.random.uniform(ks[1], (s,), minval=0.02, maxval=0.33)),
        t(jax.random.uniform(ks[2], (s,), minval=np.log(0.3),
                             maxval=np.log(3.3))),
        t(jax.random.uniform(ks[3], (s,))), t(jax.random.uniform(ks[4], (s,))))
    return FastDraws(t(end), t(rot), er)


def jax_cut_draws(key, sampler, transform: str) -> CutDraws:
    """The draws of one `encode_cuts(key)` pass of the JAX step."""
    k_box, k_tf = jax.random.split(key)
    boxes = Boxes(*(t(b) for b in sampler.sample_boxes(k_box)))
    m = sampler.modsize
    aug = (jax_fast_draws(k_tf, sampler.count, m, m) if transform == "fast"
           else None)
    return CutDraws(boxes, aug)


def jax_step_draws(key, sampler, settings, param_shape) -> StepDraws:
    """The draws of aphantasia_tpu.parallel.step's loss_fn(key)."""
    k_noise, k_s1, k_s2 = jax.random.split(key, 3)
    shift = None
    if settings.noise > 0:
        u = jax.random.uniform(k_noise, (1, 1, param_shape[2], param_shape[3], 1))
        if settings.noise_centered:
            u = u - 0.5
        shift = t(settings.noise * u)
    cuts2 = (jax_cut_draws(k_s2, sampler, settings.transform)
             if settings.enforce != 0 else None)
    return StepDraws(shift, jax_cut_draws(k_s1, sampler, settings.transform),
                     cuts2)


def tree_np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)
