"""The one traffic generator: it reads a traffic mix (traffic/<name>.json)
and drives the program with it through the mode the mix names.

A mix is data: its "mode" names the file modes/<mode>.py that sends its
requests, and its other keys are that mode's parameters, each of which the
mode reads (a mix with a key its mode does not read is refused). Every mix
has a "pool" of queries, drawn by the configuration's generator from the
seed, and "filters": a filter is the program's filter string and the
reference's `where` list of [column, op, value]; pool query i is asked
under filter i % len(filters).

A mode's module holds KEYS, the keys a mix of it has, and Mode, which offers
warmup(), run(seconds, tracer) -> Window and close().
"""
from __future__ import annotations

import importlib.util
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TABLE = "docs"
COMMON_KEYS = {"mode", "pool", "filters"}


@dataclass
class Window:
    """One window's requests (issue and completion times on the monotonic
    clock, queries each, whether the answer came whole) and their answers
    (pool query, filter, ids [m, k] with -1 where a row is missing,
    distances [m, k])."""
    start: float
    t0: np.ndarray
    t1: np.ndarray
    nq: np.ndarray
    ok: np.ndarray
    pool: np.ndarray
    filt: np.ndarray
    ids: np.ndarray
    dists: np.ndarray
    first_error: Optional[str] = None


def mode_module(name: str):
    path = os.path.join(HERE, "modes", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_mode_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(mix: dict, cfg: dict, data: dict, seed: int):
    """The mode of a traffic mix, set up against the loaded table."""
    mod = mode_module(mix["mode"])
    if set(mix) != COMMON_KEYS | mod.KEYS:
        raise ValueError(f"traffic mix keys {sorted(mix)}; mode "
                         f"{mix['mode']!r} reads "
                         f"{sorted(COMMON_KEYS | mod.KEYS)}")
    return mod.Mode(mix, cfg, data, seed)


def rows_to_arrays(rows, k: int):
    """Result rows [{"ID", "@distance"}, ...] -> (ids [k], dists [k], ok):
    ok when there are exactly k of them."""
    ids = np.full(k, -1, np.int64)
    d = np.full(k, np.nan)
    m = min(len(rows), k)
    ids[:m] = [int(r["ID"]) for r in rows[:m]]
    d[:m] = [float(r["@distance"]) for r in rows[:m]]
    return ids, d, len(rows) == k


class QueryMode:
    """A mode whose requests are single vdb.query calls, each answer kept
    for the check."""

    def __init__(self, mix, cfg, data, seed):
        self.mix = mix
        self.field, self.k = cfg["field"], cfg["k"]
        self.queries = data["queries"]
        self.pool = len(self.queries)
        self.filters = [f["filter"] for f in mix["filters"]]

    def call(self, i: int):
        """Pool query i under its filter -> (ids [k], dists [k], ok)."""
        import vectordb_tpu_torch as vdb

        code, rows = vdb.query(TABLE, self.field, self.queries[i], ["ID"],
                               self.k, self.filters[i % len(self.filters)],
                               True)
        if code != 0:
            raise RuntimeError(f"vdb.query returned {code}")
        return rows_to_arrays(rows, self.k)

    def timed_call(self, i: int, tracer):
        """(issued, answered, pool query, answer or None, error or None)."""
        s = time.monotonic()
        try:
            with tracer.span("bench.call"):
                a, err = self.call(i), None
        except Exception as e:  # a failed query is counted, not fatal
            a, err = None, repr(e)
        return s, time.monotonic(), i, a, err

    def window(self, start: float, records: list) -> Window:
        """The Window of (issued, answered, pool query, answer, error)
        records."""
        records = sorted(records, key=lambda r: r[0])
        m, k = len(records), self.k
        ids = np.full((m, k), -1, np.int64)
        dists = np.full((m, k), np.nan)
        ok = np.zeros(m, bool)
        for r, (_, _, _, a, _) in enumerate(records):
            if a is not None:
                ids[r], dists[r], ok[r] = a
        pool = np.asarray([r[2] for r in records], np.int64)
        errors = [r[4] for r in records if r[4] is not None]
        return Window(start, np.asarray([r[0] for r in records]),
                      np.asarray([r[1] for r in records]),
                      np.ones(m, np.int64), ok, pool,
                      pool % len(self.filters), ids, dists,
                      errors[0] if errors else None)

    def close(self) -> None:
        pass
