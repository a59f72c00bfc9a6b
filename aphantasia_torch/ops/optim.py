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
"""
from __future__ import annotations

import dataclasses

import torch


def lr_schedule(lrate: float, steps: int, prog: bool = False):
    """A constant, or the `--prog` ramp as a function of the step count."""
    if not prog:
        return lrate
    lr1 = lrate * 2.0
    lr0 = lr1 * 0.01
    return lambda i: lr0 + (i / steps) * (lr1 - lr0)


@dataclasses.dataclass
class OptState:
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    nu_max: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam / AdamW / AMSGrad with optax's update order and bias
    corrections.  `step` updates the params and the state IN PLACE (the
    JAX step donates their buffers to the same effect)."""
    lr: object                   # float or schedule(count) -> float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    amsgrad: bool = False

    def init(self, params: torch.Tensor) -> OptState:
        z = torch.zeros_like(params)
        return OptState(0, z.clone(), z.clone(),
                        z.clone() if self.amsgrad else None)

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             state: OptState) -> None:
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        state.mu.mul_(self.b1).add_(grads, alpha=1.0 - self.b1)
        state.nu.mul_(self.b2).addcmul_(grads, grads, value=1.0 - self.b2)
        state.count += 1
        mu_hat = state.mu / (1.0 - self.b1 ** state.count)
        nu_hat = state.nu / (1.0 - self.b2 ** state.count)
        if self.amsgrad:
            torch.maximum(state.nu_max, nu_hat, out=state.nu_max)
            nu_hat = state.nu_max
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay:
            update = update + self.weight_decay * params
        params.sub_(lr * update)


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
