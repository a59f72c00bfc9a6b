"""Rounding for the control: a value and, in the backward, its gradient
rounded to a lower precision, the arithmetic then in float32."""
from __future__ import annotations

import dataclasses

import torch

FP8_MAX = 448.0          # float8_e4m3fn's largest finite value


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), as an fp8 path stores an operand."""
    amax = x.detach().abs().amax().clamp(min=1e-30).float()
    s = amax / FP8_MAX
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


@dataclasses.dataclass(frozen=True)
class Precision:
    """`low` rounds where the program computes in bf16, `full` where it
    computes in float32; None keeps float32 (the reference)."""
    low: object = None
    full: object = None

    def lo(self, x):
        return x if self.low is None else _Round.apply(x, self.low)

    def hi(self, x):
        return x if self.full is None else _Round.apply(x, self.full)


REFERENCE = Precision()
CONTROL = Precision(low=to_fp8, full=to_bf16)


def float32_mode() -> None:
    """Products in float32 proper: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
