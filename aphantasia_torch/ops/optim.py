"""The optimizer menu of the JAX package (counterpart of
aphantasia_tpu.ops.optim), written out so that each one equals its optax
chain step for step:

  adam          optax.adam(lr)                      b1 0.9, b2 0.999
  adam_custom   optax.adam(lr, b1=0.0, b2=0.999)    [default]
  adamw         optax.adamw(lr, weight_decay=0.01)
  adamw_custom  scale_by_amsgrad(b1=0, b2=0.999) + add_decayed_weights(0.01)
                + scale_by_learning_rate(lr)

all with eps 1e-8, plus the progressive ramp (`--prog`): lr goes linearly
from 0.02*lrate to 2*lrate over the run, read at the step count before the
update (optax's schedule convention).

The step count is an int32 tensor on the params' device, increased in
place, and the bias corrections and the ramp are computed from it on that
device in float32, as optax computes them: a CUDA graph that captures the
update replays it with the count it reads at each replay.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def lr_schedule(lrate: float, steps: int, prog: bool = False):
    """A constant, or the `--prog` ramp as a function of the step count."""
    if not prog:
        return lrate
    lr1 = lrate * 2.0
    lr0 = lr1 * 0.01
    return lambda i: lr0 + (i / steps) * (lr1 - lr0)


def leaves(tree) -> list:
    """The tensors of a params tree: a tensor, or a list of tensors (the
    DWT pyramid)."""
    return list(tree) if isinstance(tree, (list, tuple)) else [tree]


@dataclasses.dataclass
class OptState:
    """`mu`, `nu` and `nu_max` mirror the params: a tensor each, or a list
    of tensors for list params; `count` is shared."""
    count: torch.Tensor          # int32, 0-d, on the params' device
    mu: Any
    nu: Any
    nu_max: Any = None


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam / AdamW / AMSGrad with optax's update order and bias
    corrections.  `step` updates the params and the state IN PLACE (the
    JAX step donates their buffers to the same effect).  Params are a
    tensor or a list of tensors; optax updates every leaf by the same rule
    with one step count, and so does `step`."""
    lr: object                   # float or schedule(count) -> float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    amsgrad: bool = False

    def init(self, params) -> OptState:
        ps = leaves(params)
        count = torch.zeros((), dtype=torch.int32, device=ps[0].device)

        def zeros():
            z = [torch.zeros_like(p) for p in ps]
            return z if isinstance(params, (list, tuple)) else z[0]
        return OptState(count, zeros(), zeros(),
                        zeros() if self.amsgrad else None)

    def step(self, params, grads, state: OptState) -> None:
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        state.count.add_(1)
        # optax's bias_correction: 1 - decay ** count in float32
        count = state.count.float()
        c1 = 1.0 - torch.pow(self.b1, count)
        c2 = 1.0 - torch.pow(self.b2, count)
        nu_max = (leaves(state.nu_max) if self.amsgrad
                  else [None] * len(leaves(params)))
        for p, g, mu, nu, mx in zip(leaves(params), leaves(grads),
                                    leaves(state.mu), leaves(state.nu),
                                    nu_max, strict=True):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            mu_hat = mu / c1
            nu_hat = nu / c2
            if self.amsgrad:
                torch.maximum(mx, nu_hat, out=mx)
                nu_hat = mx
            update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.sub_(lr * update)


def build_optimizer(name: str, lrate, steps: int = 0, prog: bool = False):
    lr = lr_schedule(lrate, max(steps, 1), prog)
    name = name.lower()
    if name == "adamw":
        return Adam(lr, weight_decay=0.01)
    if name == "adamw_custom":
        return Adam(lr, b1=0.0, weight_decay=0.01, amsgrad=True)
    if name == "adam":
        return Adam(lr)
    if name == "adam_custom":
        return Adam(lr, b1=0.0)
    raise ValueError(f"unknown optimizer {name!r}")
