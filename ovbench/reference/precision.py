"""The precision the plain reference computes in.

`FLOAT32` is the reference: every product in float32, the int8 teacher
convs as exact integer products, as the configuration states them.
`CONTROL` is the same reference one step lower, the step a later change
might be tempted to take: every matrix product of the detector, its
attention included, on float8 (e4m3) operands, and the teacher's W8A8
convs as W4A4.  A model is built with one of them and reads nothing else.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its abs-max
    at the format's largest value), back in float32; the gradient passes
    straight through the rounding."""
    t = t.float()
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / _E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


@dataclass(frozen=True)
class Precision:
    name: str
    fp8_products: bool
    int_levels: int  # the largest code of the teacher's symmetric integer grid

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A matrix product's operand: float32, or float8 in the control."""
        return _fp8(t) if self.fp8_products else t.float()


FLOAT32 = Precision("float32", False, 127)
CONTROL = Precision("control", True, 7)
