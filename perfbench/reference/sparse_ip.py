"""The plain reference of a sparse inner-product table: every pool query
against every row.

A CSR matrix of the raw rows times a dense block of queries, in float64,
or, as the control, in float32 of values rounded to bfloat16 (the precision
below the configuration's float32). The distance is the inner product
negated; an error in it is measured against sum |q_i x_i| of the pair,
which a second product of absolute values gives where a value is negative.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

PRECISIONS = {"float64": torch.float64, "bfloat16": torch.float32}


class Reference:
    block = 128

    def __init__(self, raw: dict, queries, dev: torch.device,
                 precision: str = "float64"):
        self.dt = PRECISIONS[precision]
        self.bf16 = precision == "bfloat16"
        self.dev = dev
        self.vocab = raw["vocab"]
        self.queries = queries
        n = len(raw["offsets"]) - 1
        vals = self._cast(torch.from_numpy(raw["values"]))
        crow = torch.from_numpy(raw["offsets"])
        col = torch.from_numpy(raw["indices"])
        with warnings.catch_warnings():  # "beta" and invariant notices
            warnings.simplefilter("ignore", UserWarning)
            self.csr = torch.sparse_csr_tensor(crow, col, vals,
                                               size=(n, self.vocab)).to(dev)
            self.abs_csr = None
            if (raw["values"] < 0).any():
                self.abs_csr = torch.sparse_csr_tensor(
                    crow, col, vals.abs(), size=(n, self.vocab)).to(dev)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        if self.bf16:
            t = t.to(torch.bfloat16)
        return t.to(self.dt)

    def distances(self, qidx: np.ndarray):
        dense = np.zeros((self.vocab, len(qidx)), np.float64)
        for j, i in enumerate(qidx):
            q = self.queries[i]
            dense[np.asarray(q["indices"], np.int64), j] = q["values"]
        t = self._cast(torch.from_numpy(dense)).to(self.dev)
        d = (self.csr @ t).neg_()
        scale = None if self.abs_csr is None else self.abs_csr @ t.abs()
        return d, scale
