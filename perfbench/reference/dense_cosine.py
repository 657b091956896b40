"""The plain reference of a cosine table: every pool query against every row.

Rows and queries are scaled to unit length and multiplied in float64; the
distance is 1 - cos. As the control, the same in float32 with the product
in TF32 (the precision below the configuration's float32 with TF32 off):
the unit rows and queries rounded to TF32's 10-bit mantissa, as the tensor
cores take them, and multiplied in float32, so the control reads the same
on a CPU.

The error of a reported distance is measured against 1, the largest |cos|
of two unit vectors. Rounding in 1 - cos happens at the scale of the
products' sum, not of the distance: a float32 sum of unit-vector products
carries an absolute error of the order of 1e-7 whatever the distance, so a
near duplicate's small distance divided into it would count rounding as a
large error, where the same rounding far from the query would count as
none.
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
        self.x = cast(unit_rows(torch.from_numpy(raw["x"]).to(dev, dt)))
        self.q = cast(unit_rows(torch.from_numpy(np.asarray(queries)).to(
            dev, dt)))

    def distances(self, qidx: np.ndarray):
        q = self.q[torch.from_numpy(qidx).to(self.q.device)]
        d = torch.matmul(self.x, q.T).neg_().add_(1.0)
        return d, torch.ones((1, 1), dtype=d.dtype,
                             device=d.device).expand(d.shape)


def unit_rows(t: torch.Tensor) -> torch.Tensor:
    """Each row divided by its Euclidean norm, in place; a zero row stays
    zero."""
    n = torch.linalg.vector_norm(t, dim=1, keepdim=True)
    return t.div_(torch.where(n > 0, n, torch.ones_like(n)))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 (10 mantissa bits, ties
    away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
