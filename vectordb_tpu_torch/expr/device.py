"""Filter masks evaluated on the device (counterpart of
vectordb_tpu/expr/device.py).

The host FilterCompiler (evaluator.py) evaluates a parsed filter as
whole-column numpy operations. For numeric, bool and geo predicate trees
this module evaluates the same tree as torch ops over the segment's
device-resident columns (segment.device_column), so a filtered query
evaluates no host mask over all rows and uploads no per-query mask: the
columns are cached per segment mutation version and the constants go up
once per filter.

Evaluators are keyed by the tree's structure (node types, fields,
operators) and built once per structure; the constants come in as one
device tensor, so `price > 10` and `price > 99` share one evaluator.

Semantics are the host evaluator's, node for node: int attributes and int
constants are int64 and DOUBLE / FLOAT attributes and double constants
float64, with numpy's promotion (int64 op float64 -> float64, int64 op
int64 -> int64, wrapping on overflow); Divide is true division in float64
and Module is C fmod (truncation toward zero, int64 for two int operands),
both giving 0 where the divisor is 0; bools read as 1.0 / 0.0 in
arithmetic; NEARBY is the float64 haversine of evaluator.haversine_km. The
device mask therefore equals the host mask bit for bit, with one limit:
NEARBY's sin, cos and arctan2 come from torch's math library, which may
round the last bit of a distance differently from numpy's, so a row
within an ulp of the radius can fall the other way. vectordb_tpu evaluates
in float32 instead, which rounds DOUBLE columns and constants and can flip
comparisons the host keeps (ROADMAP queue 3).

Strings, LIKE, IN and @distance are not device-compilable and stay on the
host (is_device_compilable returns False). On the sharded plane
(parallel/engine.py) the same evaluator runs once a shard
(`mask_from_cols` over that shard's columns, on its device; the constants
go to each device once), where the JAX module evaluates [S, cap_s]
float32 columns with `replicated_consts`.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from .._device import default_device
from ..errors import INVALID_EXPR, VectorDBError
from ..metrics import metrics
from .evaluator import _EARTH_RADIUS_KM
from .parser import ExprNode, NodeType, ValueType

# Node types a device mask can contain.
_INT_ATTRS = (NodeType.Int1Attr, NodeType.Int2Attr, NodeType.Int4Attr,
              NodeType.Int8Attr)
_FLOAT_ATTRS = (NodeType.DoubleAttr, NodeType.FloatAttr)
_NUMERIC_ATTRS = _INT_ATTRS + _FLOAT_ATTRS
_ARITH = (NodeType.Add, NodeType.Subtract, NodeType.Multiply,
          NodeType.Divide, NodeType.Module)
_CMP = (NodeType.EQ, NodeType.NE, NodeType.LT, NodeType.LTE, NodeType.GT,
        NodeType.GTE)
_LOGIC = (NodeType.AND, NodeType.OR, NodeType.NOT)
_CONSTS = (NodeType.IntConst, NodeType.DoubleConst, NodeType.BoolConst)


def is_device_compilable(nodes: List[ExprNode]) -> bool:
    """True when every node in the tree maps to torch ops over primitive /
    geo columns (no strings, no @distance)."""
    if not nodes:
        return False
    for n in nodes:
        t = n.node_type
        if t in _CONSTS or t in _ARITH or t in _CMP or t in _LOGIC:
            continue
        if t in _NUMERIC_ATTRS:
            if n.field_name == "@distance":
                return False
            continue
        if t in (NodeType.BoolAttr, NodeType.GeoPointAttr):
            continue
        if t == NodeType.FunctionCall and n.function_name == "NEARBY":
            continue
        # Anything else (strings, IN, LIKE, aggregations) -> host path.
        return False
    return True


def _structure_key(nodes: List[ExprNode]) -> Tuple:
    """Everything about the tree except constant VALUES (enums by value so
    the key is hashable + stable)."""
    out = []
    for n in nodes:
        out.append((n.node_type.value, n.value_type.value,
                    n.field_name or "", int(n.left), int(n.right),
                    n.function_name or "", tuple(n.arguments or ())))
    return tuple(out)


def collect_constants(nodes: List[ExprNode]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Constant values in node order: (f64, i64). f64 holds every constant
    as float64 (IntConst as float(int_value), BoolConst as 1.0 / 0.0, 0.0
    at other nodes); i64 holds IntConst values as int64 (0 elsewhere),
    since the host evaluator keeps int constants as int64 and an int
    constant of 2^53 or more is not a float64."""
    f64 = np.zeros(len(nodes), dtype=np.float64)
    i64 = np.zeros(len(nodes), dtype=np.int64)
    for i, n in enumerate(nodes):
        if n.node_type == NodeType.IntConst:
            f64[i] = float(n.int_value)
            i64[i] = n.int_value
        elif n.node_type == NodeType.DoubleConst:
            f64[i] = n.double_value
        elif n.node_type == NodeType.BoolConst:
            f64[i] = 1.0 if n.bool_value else 0.0
    return f64, i64


def collect_fields(nodes: List[ExprNode]) -> List[str]:
    """Field names referenced (order = first appearance). Geo fields appear
    once; their columns are passed as (lat, lon) pairs."""
    seen = []
    for n in nodes:
        if (n.node_type in _NUMERIC_ATTRS
                or n.node_type in (NodeType.BoolAttr, NodeType.GeoPointAttr)
                ) and n.field_name and n.field_name not in seen:
            seen.append(n.field_name)
    return seen


class _N:
    """Node view rebuilt from a structure key entry."""
    __slots__ = ("node_type", "value_type", "field_name", "left", "right",
                 "function_name", "arguments")

    def __init__(self, tup):
        (t, vt, self.field_name, self.left, self.right, self.function_name,
         self.arguments) = tup
        self.node_type = NodeType(t)
        self.value_type = ValueType(vt)


@functools.lru_cache(maxsize=256)
def _compiled_for_structure(key: Tuple, field_order: Tuple[str, ...]):
    """The evaluator of one tree structure: run(consts, valid_dev, cols) ->
    valid_dev & filter, a [capacity] bool tensor. consts is the [2, nodes]
    int64 tensor of DeviceFilter (row 0 the float64 constants' bits, row 1
    the int64 constants); cols the columns in field_order."""
    nodes = [_N(t) for t in key]
    f_idx = {name: i for i, name in enumerate(field_order)}

    def num_eval(i, c, cols, n):
        nd = nodes[i]
        t = nd.node_type
        if t == NodeType.IntConst:
            return c[1][i].expand(n)
        if t in (NodeType.DoubleConst, NodeType.BoolConst):
            return c[0][i].expand(n)
        if t in _NUMERIC_ATTRS:
            return cols[f_idx[nd.field_name]]
        if t == NodeType.BoolAttr:
            return cols[f_idx[nd.field_name]].to(torch.float64)
        if t in _ARITH:
            le = num_eval(nd.left, c, cols, n)
            r = num_eval(nd.right, c, cols, n)
            if t == NodeType.Add:
                return le + r
            if t == NodeType.Subtract:
                return le - r
            if t == NodeType.Multiply:
                return le * r
            if t == NodeType.Divide:
                le, r = le.to(torch.float64), r.to(torch.float64)
                return torch.where(r != 0, le / r, 0.0)
            if le.dtype == torch.int64 and r.dtype == torch.int64:
                # x fmod 1 == x fmod -1 == 0: the divisor 1 stands in for 0
                # (masked below) and for -1 (INT64_MIN fmod -1 traps).
                safe = torch.where((r == 0) | (r == -1), 1, r)
                return torch.where(r != 0, torch.fmod(le, safe), 0)
            le, r = le.to(torch.float64), r.to(torch.float64)
            return torch.where(r != 0, torch.fmod(le, r), 0.0)
        raise VectorDBError(INVALID_EXPR,
                            f"Cannot evaluate node {t} numerically.")

    def haversine_km(lat_col, lon_col, lat_c, lon_c):
        # evaluator.haversine_km, operation for operation, in float64.
        lat1, lon1 = torch.deg2rad(lat_col), torch.deg2rad(lon_col)
        lat2, lon2 = torch.deg2rad(lat_c), torch.deg2rad(lon_c)
        dlat = lat2 - lat1
        dlon = lon2 - lon1
        a = (torch.sin(dlat / 2.0) ** 2
             + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2.0) ** 2)
        return _EARTH_RADIUS_KM * 2.0 * torch.atan2(torch.sqrt(a),
                                                    torch.sqrt(1.0 - a))

    def bool_eval(i, c, cols, n):
        nd = nodes[i]
        t = nd.node_type
        if t == NodeType.BoolConst:
            return (c[0][i] != 0).expand(n)
        if t == NodeType.BoolAttr:
            return cols[f_idx[nd.field_name]]
        if t == NodeType.AND:
            return bool_eval(nd.left, c, cols, n) & bool_eval(nd.right, c,
                                                              cols, n)
        if t == NodeType.OR:
            return bool_eval(nd.left, c, cols, n) | bool_eval(nd.right, c,
                                                              cols, n)
        if t == NodeType.NOT:
            return ~bool_eval(nd.left, c, cols, n)
        if t in _CMP:
            if (nodes[nd.left].value_type == ValueType.BOOL
                    and nodes[nd.right].value_type == ValueType.BOOL):
                le = bool_eval(nd.left, c, cols, n)
                r = bool_eval(nd.right, c, cols, n)
                if t == NodeType.EQ:
                    return le == r
                if t == NodeType.NE:
                    return le != r
                raise VectorDBError(INVALID_EXPR, "Invalid bool comparison.")
            le = num_eval(nd.left, c, cols, n)
            r = num_eval(nd.right, c, cols, n)
            if t == NodeType.EQ:
                return le == r
            if t == NodeType.NE:
                return le != r
            if t == NodeType.LT:
                return le < r
            if t == NodeType.LTE:
                return le <= r
            if t == NodeType.GT:
                return le > r
            return le >= r
        if t == NodeType.FunctionCall and nd.function_name == "NEARBY":
            geo, la, lo, rad = nd.arguments
            lat_col, lon_col = cols[f_idx[nodes[geo].field_name]]
            d = haversine_km(lat_col, lon_col, c[0][la], c[0][lo])
            return d <= c[0][rad]
        raise VectorDBError(INVALID_EXPR, f"Cannot evaluate node {t} as bool.")

    def run(consts: torch.Tensor, valid_dev: torch.Tensor, cols
            ) -> torch.Tensor:
        c = (consts[0].view(torch.float64), consts[1])
        return valid_dev & bool_eval(len(nodes) - 1, c, cols,
                                     valid_dev.shape[0])

    return run


class DeviceFilter:
    """Device mask of one parsed filter (structure + constants) over one
    segment. Table keeps these per filter (256 entries): the constants go
    to each device once, the columns are cached per mutation version on
    the segment (on the sharded plane, by parallel/engine.py), and the
    evaluator per structure process-wide, so a repeated filter transfers
    nothing to the device per query. Masks, and the ids of the rows each
    keeps, are cached per (mutation version, validity mask)."""

    # Composed masks kept (one per validity tensor: one a shard on the
    # sharded plane).
    MASK_CACHE = 64

    def __init__(self, nodes: List[ExprNode], segment):
        self.nodes = nodes
        self.segment = segment
        self.field_order = tuple(collect_fields(nodes))
        f64, i64 = collect_constants(nodes)
        self.consts = torch.from_numpy(
            np.stack([f64.view(np.int64), i64])).to(default_device())
        self._consts_by_device = {self.consts.device: self.consts}
        self._fn = _compiled_for_structure(_structure_key(nodes),
                                           self.field_order)
        # id(valid_dev) -> [mutation version, valid_dev, mask, kept ids or
        # None]: holding the validity tensor keeps its id from being reused
        # while cached.
        self._masks: Dict[int, list] = {}
        self._count = None  # sharded plane: (mutation version, masks, count)

    def _evaluate(self, valid_dev: torch.Tensor, cols_fn) -> torch.Tensor:
        ver = self.segment.mutation_version
        hit = self._masks.get(id(valid_dev))
        if hit is not None and hit[0] == ver and hit[1] is valid_dev:
            return hit[2]
        dev = valid_dev.device
        consts = self._consts_by_device.get(dev)
        if consts is None:
            consts = self._consts_by_device[dev] = self.consts.to(dev)
        out = self._fn(consts, valid_dev, cols_fn())
        if len(self._masks) >= self.MASK_CACHE:
            self._masks.clear()
        self._masks[id(valid_dev)] = [ver, valid_dev, out, None]
        return out

    def mask(self, valid_dev: torch.Tensor, capacity: int) -> torch.Tensor:
        """valid_dev: [capacity] bool device tensor (pure validity). Returns
        the [capacity] bool mask valid & filter on the same device."""
        return self._evaluate(valid_dev, lambda: [
            self.segment.device_column(name, capacity)
            for name in self.field_order])

    def mask_from_cols(self, valid_dev: torch.Tensor, cols) -> torch.Tensor:
        """One shard of the sharded plane: valid_dev [cap_s] bool and `cols`
        (this filter's columns in field_order, geo ones as (lat, lon)) on
        the shard's device. Returns valid & filter there."""
        return self._evaluate(valid_dev, lambda: cols)

    def kept_ids(self, mask: torch.Tensor) -> torch.Tensor:
        """[m] int32 ids, ascending, of the rows a composed mask (one that
        mask() returned) keeps, on its device: one nonzero (a host sync) at
        the first call for the mask, kept beside it in its (mutation
        version, validity tensor) entry, so a write's new version or a new
        validity tensor builds a new list (counted in
        flat_id_lists_built_total)."""
        entry = next((e for e in self._masks.values() if e[2] is mask), None)
        if entry is not None and entry[3] is not None:
            return entry[3]
        ids = torch.nonzero(mask).view(-1).to(torch.int32)
        metrics.inc("flat_id_lists_built_total")
        if entry is not None:
            entry[3] = ids
        return ids

    def match_count(self, mask_dev) -> int:
        """Rows passing (validity & filter): the length of a composed mask's
        kept ids (kept_ids), or counted on the devices from the list of a
        sharded table's shard masks, one scalar copy to the host a shard per
        (mutation version, masks). Drives the selectivity gate of the graph
        path: the filtered rank-k neighbour sits near global rank
        k/selectivity, so the beam widens with it or the exact masked scan
        takes over."""
        if not isinstance(mask_dev, (list, tuple)):
            return int(self.kept_ids(mask_dev).numel())
        masks = list(mask_dev)
        ver = self.segment.mutation_version
        hit = self._count
        if (hit is not None and hit[0] == ver and len(hit[1]) == len(masks)
                and all(a is b for a, b in zip(hit[1], masks))):
            return hit[2]
        cnt = sum(int(m.sum()) for m in masks)
        self._count = (ver, masks, cnt)
        return cnt
