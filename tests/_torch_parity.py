"""Shared helpers of the tests/test_torch_*.py parity tests: the JAX
package's random draws, made from its keys exactly as its step and
pipelines split them, converted to the port's draw structures."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from aphantasia_torch.ops.augs import (CustomDraws, ElasticDraws,
                                       ErasingDraws, FastDraws, LucentDraws,
                                       OpenAIDraws)
from aphantasia_torch.ops.sampler import Boxes
from aphantasia_torch.step import CutDraws, StepDraws


def t(x, dtype=None):
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def _randint(key, shape, hi):
    return t(jax.random.randint(key, shape, 0, hi))


def jax_erasing_draws(key, s) -> ErasingDraws:
    """The draws of aphantasia_tpu.ops.augs.random_erasing(key)."""
    ks = jax.random.split(key, 5)
    return ErasingDraws(
        t(jax.random.uniform(ks[0], (s,)) < 0.2),
        t(jax.random.uniform(ks[1], (s,), minval=0.02, maxval=0.33)),
        t(jax.random.uniform(ks[2], (s,), minval=np.log(0.3),
                             maxval=np.log(3.3))),
        t(jax.random.uniform(ks[3], (s,))), t(jax.random.uniform(ks[4], (s,))))


def jax_fast_draws(key, s, h, w) -> FastDraws:
    """The draws of aphantasia_tpu.ops.augs.transforms_fast_affine(key),
    which transforms_fast_mixed and transforms_fast split alike."""
    from aphantasia_tpu.ops.augs import _ROT_ANGLES
    from aphantasia_tpu.ops.perspective import perspective_endpoints
    k1, k2, k3 = jax.random.split(key, 3)
    _, end = perspective_endpoints(k1, s, h, w, distortion=0.33, p=0.2)
    return FastDraws(t(end), _randint(k2, (s,), len(_ROT_ANGLES)),
                     jax_erasing_draws(k3, s))


def jax_custom_draws(key, s, h, w) -> CustomDraws:
    """The draws of transforms_custom(key)."""
    from aphantasia_tpu.ops.augs import _ROT_ANGLES
    k1, k2 = jax.random.split(key)
    return CustomDraws(_randint(k1, (s,), len(_ROT_ANGLES)),
                       _randint(k2, (s, 2), 8))


def jax_elastic_draws(key, s, h, w) -> ElasticDraws:
    """The draws of transforms_elastic(key)."""
    from aphantasia_tpu.ops.augs import _ROT_ANGLES
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return ElasticDraws(
        _randint(k1, (s,), len(_ROT_ANGLES)), _randint(k2, (s, 2), 8),
        jax_erasing_draws(k3, s),
        t(jax.random.uniform(k4, (s, 9), minval=-1.0, maxval=1.0)),
        t(jax.random.uniform(k5, (s, 9), minval=-1.0, maxval=1.0)))


def jax_lucent_draws(key, s, h, w) -> LucentDraws:
    """The draws of transforms_lucent(key)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return LucentDraws(_randint(k1, (s, 2), 8), _randint(k2, (s,), 11),
                       _randint(k3, (s,), 26), _randint(k4, (s, 2), 4))


def jax_openai_draws(key, s, h, w) -> OpenAIDraws:
    """The draws of transforms_openai(key): the ten jitters summed."""
    ks = jax.random.split(key, 12)
    jit10 = sum(np.asarray(jax.random.randint(ks[i], (s, 2), 0, 4))
                for i in range(10))
    return OpenAIDraws(t(jit10), _randint(ks[10], (s,), 75),
                       _randint(ks[11], (s, 2), 2))


JAX_DRAWS = {"fast": jax_fast_draws, "custom": jax_custom_draws,
             "elastic": jax_elastic_draws, "lucent": jax_lucent_draws,
             "openai": jax_openai_draws, "none": lambda key, s, h, w: None}


def jax_cut_draws(key, sampler, transform: str) -> CutDraws:
    """The draws of one `encode_cuts(key)` pass of the JAX step."""
    k_box, k_tf = jax.random.split(key)
    boxes = Boxes(*(t(b) for b in sampler.sample_boxes(k_box)))
    m = sampler.modsize
    return CutDraws(boxes, JAX_DRAWS[transform](k_tf, sampler.count, m, m))


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
