"""The plain reference of an L2 table: every pool query against every row.

Squared L2 distances by the expansion |x|^2 - 2 q.x + |q|^2 over all rows,
in float64 (exact to about 1e-13 of |x|^2 at these magnitudes, far below
the float32 rounding the configuration allows) or, as the control, in
float32 with the product in TF32 (the precision below the configuration's
float32 with TF32 off): both operands rounded to TF32's 10-bit mantissa,
as the tensor cores take them, and multiplied in float32, so the control
reads the same on a CPU.
"""
from __future__ import annotations

import numpy as np
import torch

PRECISIONS = {"float64": torch.float64, "tf32": torch.float32}


class Reference:
    block = 256

    def __init__(self, raw: dict, queries, dev: torch.device,
                 precision: str = "float64"):
        dt = PRECISIONS[precision]
        cast = tf32_round if precision == "tf32" else (lambda t: t)
        self.x = cast(torch.from_numpy(raw["x"]).to(dev, dt))
        self.xn = (self.x * self.x).sum(1)
        self.q = cast(torch.from_numpy(np.asarray(queries)).to(dev, dt))

    def distances(self, qidx: np.ndarray):
        q = self.q[torch.from_numpy(qidx).to(self.q.device)]
        d = self.x @ q.T
        d.mul_(-2.0).add_(self.xn[:, None]).add_((q * q).sum(1)[None, :])
        return d, None


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 (10 mantissa bits, ties
    away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
