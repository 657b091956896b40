"""The rows and queries of `latent`, bit for bit, and a STRING `labels`
column: each row carries exactly one of the configuration's `labels`,
drawn i.i.d. at the stated shares by numpy.random.default_rng(data_seed),
so the column is one fixed draw as the rows are. The column is an object
array of Python str, the very values the program stores and the reference
compares. Keys of the configuration that neither this file nor `latent`
reads are ignored."""
from __future__ import annotations

import numpy as np

from perfbench.generators import latent

COLUMN = "labels"


def draw_labels(labels: dict, n: int, data_seed: int) -> np.ndarray:
    """n labels drawn at the shares of `labels` (value -> share, the shares
    summing to 1), as an object array of str."""
    values = np.empty(len(labels), dtype=object)
    values[:] = list(labels)
    shares = np.fromiter(labels.values(), np.float64, len(labels))
    rng = np.random.default_rng(data_seed)
    return values[rng.choice(len(labels), size=n, p=shares)]


def make(cfg: dict, seed: int, dev, pool: int) -> dict:
    data = latent.make(cfg, seed, dev, pool)
    data["attributes"][COLUMN] = draw_labels(cfg["labels"], data["n"],
                                             cfg["data_seed"])
    data["schema"].append({"name": COLUMN, "dataType": "STRING"})
    return data
