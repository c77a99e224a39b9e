"""The lower-precision control of a served reference: the operands of its
convolutions and dense layers rounded to float8 (e4m3, one scale a
tensor), the rest in bfloat16. A reference model's conv and dense layers
take :class:`Quantizable` and call :meth:`Quantizable.operands`."""

from __future__ import annotations

import torch
import torch.nn as nn

FP8_MAX = 448.0


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude maps to 448), returned in its own dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(t.dtype)


class Quantizable:
    fp8 = False

    def operands(self, x, weight):
        if not self.fp8:
            return x, weight
        return fake_fp8(x), fake_fp8(weight)


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    """Round the operands of every conv and dense layer to float8."""
    for m in model.modules():
        if isinstance(m, Quantizable):
            m.fp8 = on
    return model
