"""The dense routing decisions of vectordb_tpu_torch.Table, pinned route by
route: which route a batch takes (graph walk, exact flat scan, or the
per-batch pipeline) and the integers each graph walk is launched with.

Recording fakes stand in for the four walk launchers (ReplayCache.
search_topk of the single-query route, beam_search_grouped of the grouped
graph route, and the sharded field's launch / launch_grouped), for the flat
scan (flat_topk, and id_topk, its scan of a device filter's kept rows) and
for the per-batch pipeline. Each fake records its
arguments and stops the query, so no walk runs. The grid covers the beam
width override, k, a filter keeping all, a third or a twentieth of the
rows, and the tuned depth override. The expected values are frozen below;
a change of any route's width, termination window, depth, candidate width
or compaction shows as a mismatch here.

The same file holds the projection check: the REST route's column buffers
decode to the row dicts of Table.project, over every field type.
"""
import inspect

import numpy as np
import pytest

import vectordb_tpu_torch as vdb
from vectordb_tpu_torch.config import global_config
from vectordb_tpu_torch.expr.evaluator import FilterCompiler
from vectordb_tpu_torch.expr.parser import parse_expr
from vectordb_tpu_torch.ops import beam as beam_ops
from vectordb_tpu_torch.ops import flat as flat_ops
from vectordb_tpu_torch.parallel import engine
from vectordb_tpu_torch.table import Table

N, DIM, FIELD = 2000, 16, "V"
GROUP_Q, GROUP_BATCH = 40, 16

# Keep fractions: every row, a third, a twentieth. The device sites filter
# on the integer column, the host-fold sites on the string column, and the
# grouped sharded route (which takes no filter) on a host-folded mask.
DEVICE_FILTERS = {"all": "Cat < 60", "third": "Cat < 20",
                  "twentieth": "Cat < 3"}
HOST_FILTERS = {"all": "Tag LIKE '%'",
                "third": "Tag LIKE '0%' OR Tag LIKE '1%'",
                "twentieth": "Tag IN ('00', '01', '02')"}

SITES = ("dispatch", "grouped_graph", "host_fold", "sharded_launch",
         "grouped_sharded", "host_fold_sharded")
EFS = (0, 8, 200)      # 0: SearchEf
KS = (1, 10, 100)
KEEPS = ("all", "third", "twentieth")
ITERS = (0, 5)         # 0: no tuned depth override


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    saved = dict(vars(global_config))
    vdb.set_device("cpu")
    engine._reset_for_tests()
    global_config.flat_serve = "off"
    global_config.query_group_size = 4
    global_config.minimal_graph_size = 100
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    cols = {"ID": np.arange(N), "Cat": np.arange(N) % 60,
            "Tag": [f"{i % 60:02d}" for i in range(N)], "V": x}
    fields = [{"name": "ID", "dataType": "INT", "primaryKey": True},
              {"name": "Cat", "dataType": "INT"},
              {"name": "Tag", "dataType": "STRING"},
              {"name": FIELD, "dataType": "VECTOR_FLOAT", "dimensions": DIM,
               "metricType": "EUCLIDEAN"}]
    assert vdb.load_db("routing", str(tmp_path_factory.mktemp("r"))) == 0
    vdb.use_db("routing")
    vdb.create_table("single", fields)
    global_config.shard_count = 2
    vdb.create_table("sharded", fields)
    for name in ("single", "sharded"):
        vdb.insert_columns(name, cols)
    assert vdb.rebuild() == 0
    db = vdb._db.databases["routing"]
    single, sharded = db.tables["single"], db.tables["sharded"]
    assert single.graphs[FIELD] is not None and not single.sharded_fields
    assert sharded.sharded_fields[FIELD].graph is not None
    yield {"single": single, "sharded": sharded, "x": x}
    vdb._reset_for_tests()
    vars(global_config).update(saved)


def _bind(fn, *a, **kw):
    ba = inspect.signature(fn).bind(*a, **kw)
    ba.apply_defaults()
    return ba.arguments


def _install_fakes(monkeypatch, seen):
    """Replace every launcher with a fake that records and stops."""
    search_topk = beam_ops.ReplayCache.search_topk
    grouped = beam_ops.beam_search_grouped
    launch = engine.ShardedDenseField.launch
    launch_grouped = engine.ShardedDenseField.launch_grouped
    flat_topk = flat_ops.flat_topk
    id_topk = flat_ops.id_topk

    def fake_topk(*a, **kw):
        g = _bind(search_topk, *a, **kw)
        seen.append(("graph", g["beam_width"], g["term_width"],
                     g["max_iters"], g["k_out"], g["compact"]))
        raise _Stop

    def fake_grouped(*a, **kw):
        g = _bind(grouped, *a, **kw)
        seen.append(("graph", g["beam_width"], g["term_width"],
                     g["max_iters"], g["k_cand"], g["compact"]))
        raise _Stop

    def fake_launch(*a, **kw):
        g = _bind(launch, *a, **kw)
        if not g["use_graph"]:
            seen.append(("flat", g["k"]))
        else:
            # The engine walks `iters or beam_width` deep (_graph_kwargs).
            seen.append(("graph", g["beam_width"], g["term_width"],
                         g["iters"] or g["beam_width"], g["k"],
                         g["compact"]))
        raise _Stop

    def fake_launch_grouped(*a, **kw):
        g = _bind(launch_grouped, *a, **kw)
        seen.append(("graph", g["beam_width"], g["term_width"],
                     g["iters"] or g["beam_width"], g["k"], g["compact"]))
        raise _Stop

    def fake_flat(*a, **kw):
        seen.append(("flat", _bind(flat_topk, *a, **kw)["k"]))
        raise _Stop

    def fake_id_flat(*a, **kw):
        seen.append(("flat", _bind(id_topk, *a, **kw)["k"]))
        raise _Stop

    def fake_pipelined(*a, **kw):
        seen.append(("pipelined",))
        raise _Stop

    monkeypatch.setattr(beam_ops.ReplayCache, "search_topk", fake_topk)
    monkeypatch.setattr(beam_ops, "beam_search_grouped", fake_grouped)
    monkeypatch.setattr(engine.ShardedDenseField, "launch", fake_launch)
    monkeypatch.setattr(engine.ShardedDenseField, "launch_grouped",
                        fake_launch_grouped)
    monkeypatch.setattr(flat_ops, "flat_topk", fake_flat)
    monkeypatch.setattr(flat_ops, "id_topk", fake_id_flat)
    monkeypatch.setattr(Table, "_pipelined_batches", fake_pipelined)


def _drive(t, site, k, keep, x):
    """One query (or query set) of `site` against table `t`."""
    metric = t.metric_map[FIELD]
    valid = t.segment.valid_mask()
    q = x[1234]
    qs = x[:GROUP_Q]
    if site.startswith("host_fold"):
        nodes = parse_expr(HOST_FILTERS[keep], t.field_type_map)
        t._search_ids(FIELD, q, k, nodes, False)
        return
    if site == "grouped_sharded":
        nodes = parse_expr(HOST_FILTERS[keep], t.field_type_map)
        valid = valid & FilterCompiler(nodes, t.segment.column).mask(
            n_rows=N)
        t.grouped_dense_search(FIELD, qs, valid, metric, k,
                               batch=GROUP_BATCH, mask_cacheable=False)
        return
    nodes = parse_expr(DEVICE_FILTERS[keep], t.field_type_map)
    ctx = t._device_filter(nodes, FilterCompiler(nodes, t.segment.column))
    assert ctx is not None
    if site == "grouped_graph":
        t.grouped_dense_search(FIELD, qs, valid, metric, k,
                               batch=GROUP_BATCH, mask_cacheable=True,
                               filter_ctx=ctx)
    else:
        t.batch_dense_search(FIELD, q[None], valid, metric, k,
                             mask_cacheable=True, filter_ctx=ctx)


def capture(tables, monkeypatch, site, ef, k, keep, iters):
    """The launches recorded for one case."""
    t = tables["sharded" if "sharded" in site else "single"]
    seen = []
    with monkeypatch.context() as m:
        _install_fakes(m, seen)
        if ef:
            m.setitem(t.search_ef_override, FIELD, ef)
        else:
            m.delitem(t.search_ef_override, FIELD, raising=False)
        if iters:
            m.setitem(t.search_iters_override, FIELD, iters)
        else:
            m.delitem(t.search_iters_override, FIELD, raising=False)
        m.setattr(t, "batcher", None, raising=False)
        with pytest.raises(_Stop):
            _drive(t, site, k, keep, tables["x"])
    return seen


# Each case's launch: ("graph", beam width, termination window, depth,
# candidate width, compaction), ("flat", k) or ("pipelined",). The floors
# differ by route on purpose (Table._walk_params' callers).
EXPECTED = {
    ("dispatch", 0, 1, "all", 0): ("graph", 64, 12, 64, 9, 0),
    ("dispatch", 0, 1, "all", 5): ("graph", 64, 12, 5, 9, 0),
    ("dispatch", 0, 1, "third", 0): ("graph", 512, 128, 512, 9, 0),
    ("dispatch", 0, 1, "third", 5): ("graph", 512, 128, 512, 9, 0),
    ("dispatch", 0, 1, "twentieth", 0): ("flat", 33),
    ("dispatch", 0, 1, "twentieth", 5): ("flat", 33),
    ("dispatch", 0, 10, "all", 0): ("graph", 64, 12, 64, 18, 0),
    ("dispatch", 0, 10, "all", 5): ("graph", 64, 12, 5, 18, 0),
    ("dispatch", 0, 10, "third", 0): ("graph", 512, 128, 512, 18, 0),
    ("dispatch", 0, 10, "third", 5): ("graph", 512, 128, 512, 18, 0),
    ("dispatch", 0, 10, "twentieth", 0): ("flat", 42),
    ("dispatch", 0, 10, "twentieth", 5): ("flat", 42),
    ("dispatch", 0, 100, "all", 0): ("graph", 108, 100, 108, 108, 0),
    ("dispatch", 0, 100, "all", 5): ("graph", 108, 100, 5, 108, 0),
    ("dispatch", 0, 100, "third", 0): ("graph", 512, 512, 512, 108, 0),
    ("dispatch", 0, 100, "third", 5): ("graph", 512, 512, 512, 108, 0),
    ("dispatch", 0, 100, "twentieth", 0): ("flat", 132),
    ("dispatch", 0, 100, "twentieth", 5): ("flat", 132),
    ("dispatch", 8, 1, "all", 0): ("graph", 9, 9, 9, 9, 0),
    ("dispatch", 8, 1, "all", 5): ("graph", 9, 9, 5, 9, 0),
    ("dispatch", 8, 1, "third", 0): ("graph", 64, 64, 64, 9, 0),
    ("dispatch", 8, 1, "third", 5): ("graph", 64, 64, 64, 9, 0),
    ("dispatch", 8, 1, "twentieth", 0): ("flat", 33),
    ("dispatch", 8, 1, "twentieth", 5): ("flat", 33),
    ("dispatch", 8, 10, "all", 0): ("graph", 18, 12, 18, 18, 0),
    ("dispatch", 8, 10, "all", 5): ("graph", 18, 12, 5, 18, 0),
    ("dispatch", 8, 10, "third", 0): ("graph", 64, 64, 64, 18, 0),
    ("dispatch", 8, 10, "third", 5): ("graph", 64, 64, 64, 18, 0),
    ("dispatch", 8, 10, "twentieth", 0): ("flat", 42),
    ("dispatch", 8, 10, "twentieth", 5): ("flat", 42),
    ("dispatch", 8, 100, "all", 0): ("graph", 108, 100, 108, 108, 0),
    ("dispatch", 8, 100, "all", 5): ("graph", 108, 100, 5, 108, 0),
    ("dispatch", 8, 100, "third", 0): ("graph", 108, 108, 108, 108, 0),
    ("dispatch", 8, 100, "third", 5): ("graph", 108, 108, 108, 108, 0),
    ("dispatch", 8, 100, "twentieth", 0): ("flat", 132),
    ("dispatch", 8, 100, "twentieth", 5): ("flat", 132),
    ("dispatch", 200, 1, "all", 0): ("graph", 200, 12, 200, 9, 0),
    ("dispatch", 200, 1, "all", 5): ("graph", 200, 12, 5, 9, 0),
    ("dispatch", 200, 1, "third", 0): ("graph", 1600, 400, 1600, 9, 0),
    ("dispatch", 200, 1, "third", 5): ("graph", 1600, 400, 1600, 9, 0),
    ("dispatch", 200, 1, "twentieth", 0): ("flat", 33),
    ("dispatch", 200, 1, "twentieth", 5): ("flat", 33),
    ("dispatch", 200, 10, "all", 0): ("graph", 200, 12, 200, 18, 0),
    ("dispatch", 200, 10, "all", 5): ("graph", 200, 12, 5, 18, 0),
    ("dispatch", 200, 10, "third", 0): ("graph", 1600, 400, 1600, 18, 0),
    ("dispatch", 200, 10, "third", 5): ("graph", 1600, 400, 1600, 18, 0),
    ("dispatch", 200, 10, "twentieth", 0): ("flat", 42),
    ("dispatch", 200, 10, "twentieth", 5): ("flat", 42),
    ("dispatch", 200, 100, "all", 0): ("graph", 200, 100, 200, 108, 0),
    ("dispatch", 200, 100, "all", 5): ("graph", 200, 100, 5, 108, 0),
    ("dispatch", 200, 100, "third", 0): ("graph", 1600, 800, 1600, 108, 0),
    ("dispatch", 200, 100, "third", 5): ("graph", 1600, 800, 1600, 108, 0),
    ("dispatch", 200, 100, "twentieth", 0): ("flat", 132),
    ("dispatch", 200, 100, "twentieth", 5): ("flat", 132),
    ("grouped_graph", 0, 1, "all", 0): ("graph", 64, 12, 64, 9, 0),
    ("grouped_graph", 0, 1, "all", 5): ("graph", 64, 12, 5, 9, 0),
    ("grouped_graph", 0, 1, "third", 0): ("graph", 512, 128, 512, 9, 0),
    ("grouped_graph", 0, 1, "third", 5): ("graph", 512, 128, 512, 9, 0),
    ("grouped_graph", 0, 1, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 0, 1, "twentieth", 5): ("pipelined",),
    ("grouped_graph", 0, 10, "all", 0): ("graph", 64, 12, 64, 18, 0),
    ("grouped_graph", 0, 10, "all", 5): ("graph", 64, 12, 5, 18, 0),
    ("grouped_graph", 0, 10, "third", 0): ("graph", 512, 128, 512, 18, 0),
    ("grouped_graph", 0, 10, "third", 5): ("graph", 512, 128, 512, 18, 0),
    ("grouped_graph", 0, 10, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 0, 10, "twentieth", 5): ("pipelined",),
    ("grouped_graph", 0, 100, "all", 0): ("graph", 108, 100, 108, 108, 0),
    ("grouped_graph", 0, 100, "all", 5): ("graph", 108, 100, 5, 108, 0),
    ("grouped_graph", 0, 100, "third", 0): ("graph", 512, 512, 512, 108, 0),
    ("grouped_graph", 0, 100, "third", 5): ("graph", 512, 512, 512, 108, 0),
    ("grouped_graph", 0, 100, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 0, 100, "twentieth", 5): ("pipelined",),
    ("grouped_graph", 8, 1, "all", 0): ("graph", 9, 9, 9, 9, 0),
    ("grouped_graph", 8, 1, "all", 5): ("graph", 9, 9, 5, 9, 0),
    ("grouped_graph", 8, 1, "third", 0): ("graph", 64, 64, 64, 9, 0),
    ("grouped_graph", 8, 1, "third", 5): ("graph", 64, 64, 64, 9, 0),
    ("grouped_graph", 8, 1, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 8, 1, "twentieth", 5): ("pipelined",),
    ("grouped_graph", 8, 10, "all", 0): ("graph", 18, 12, 18, 18, 0),
    ("grouped_graph", 8, 10, "all", 5): ("graph", 18, 12, 5, 18, 0),
    ("grouped_graph", 8, 10, "third", 0): ("graph", 64, 64, 64, 18, 0),
    ("grouped_graph", 8, 10, "third", 5): ("graph", 64, 64, 64, 18, 0),
    ("grouped_graph", 8, 10, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 8, 10, "twentieth", 5): ("pipelined",),
    ("grouped_graph", 8, 100, "all", 0): ("graph", 108, 100, 108, 108, 0),
    ("grouped_graph", 8, 100, "all", 5): ("graph", 108, 100, 5, 108, 0),
    ("grouped_graph", 8, 100, "third", 0): ("graph", 108, 108, 108, 108, 0),
    ("grouped_graph", 8, 100, "third", 5): ("graph", 108, 108, 108, 108, 0),
    ("grouped_graph", 8, 100, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 8, 100, "twentieth", 5): ("pipelined",),
    ("grouped_graph", 200, 1, "all", 0): ("graph", 200, 12, 200, 9, 0),
    ("grouped_graph", 200, 1, "all", 5): ("graph", 200, 12, 5, 9, 0),
    ("grouped_graph", 200, 1, "third", 0): ("graph", 1600, 400, 1600, 9, 0),
    ("grouped_graph", 200, 1, "third", 5): ("graph", 1600, 400, 1600, 9, 0),
    ("grouped_graph", 200, 1, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 200, 1, "twentieth", 5): ("pipelined",),
    ("grouped_graph", 200, 10, "all", 0): ("graph", 200, 12, 200, 18, 0),
    ("grouped_graph", 200, 10, "all", 5): ("graph", 200, 12, 5, 18, 0),
    ("grouped_graph", 200, 10, "third", 0): ("graph", 1600, 400, 1600, 18, 0),
    ("grouped_graph", 200, 10, "third", 5): ("graph", 1600, 400, 1600, 18, 0),
    ("grouped_graph", 200, 10, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 200, 10, "twentieth", 5): ("pipelined",),
    ("grouped_graph", 200, 100, "all", 0): ("graph", 200, 100, 200, 108, 0),
    ("grouped_graph", 200, 100, "all", 5): ("graph", 200, 100, 5, 108, 0),
    ("grouped_graph", 200, 100, "third", 0):
        ("graph", 1600, 800, 1600, 108, 0),
    ("grouped_graph", 200, 100, "third", 5):
        ("graph", 1600, 800, 1600, 108, 0),
    ("grouped_graph", 200, 100, "twentieth", 0): ("pipelined",),
    ("grouped_graph", 200, 100, "twentieth", 5): ("pipelined",),
    ("host_fold", 0, 1, "all", 0): ("graph", 64, 12, 64, 9, 0),
    ("host_fold", 0, 1, "all", 5): ("graph", 64, 12, 5, 9, 0),
    ("host_fold", 0, 1, "third", 0): ("graph", 512, 128, 512, 9, 0),
    ("host_fold", 0, 1, "third", 5): ("graph", 512, 128, 512, 9, 0),
    ("host_fold", 0, 1, "twentieth", 0): ("flat", 33),
    ("host_fold", 0, 1, "twentieth", 5): ("flat", 33),
    ("host_fold", 0, 10, "all", 0): ("graph", 64, 12, 64, 18, 0),
    ("host_fold", 0, 10, "all", 5): ("graph", 64, 12, 5, 18, 0),
    ("host_fold", 0, 10, "third", 0): ("graph", 512, 128, 512, 18, 0),
    ("host_fold", 0, 10, "third", 5): ("graph", 512, 128, 512, 18, 0),
    ("host_fold", 0, 10, "twentieth", 0): ("flat", 42),
    ("host_fold", 0, 10, "twentieth", 5): ("flat", 42),
    ("host_fold", 0, 100, "all", 0): ("graph", 108, 100, 108, 108, 0),
    ("host_fold", 0, 100, "all", 5): ("graph", 108, 100, 5, 108, 0),
    ("host_fold", 0, 100, "third", 0): ("graph", 512, 512, 512, 108, 0),
    ("host_fold", 0, 100, "third", 5): ("graph", 512, 512, 512, 108, 0),
    ("host_fold", 0, 100, "twentieth", 0): ("flat", 102),
    ("host_fold", 0, 100, "twentieth", 5): ("flat", 102),
    ("host_fold", 8, 1, "all", 0): ("graph", 9, 9, 9, 9, 0),
    ("host_fold", 8, 1, "all", 5): ("graph", 9, 9, 5, 9, 0),
    ("host_fold", 8, 1, "third", 0): ("graph", 64, 64, 64, 9, 0),
    ("host_fold", 8, 1, "third", 5): ("graph", 64, 64, 64, 9, 0),
    ("host_fold", 8, 1, "twentieth", 0): ("flat", 33),
    ("host_fold", 8, 1, "twentieth", 5): ("flat", 33),
    ("host_fold", 8, 10, "all", 0): ("graph", 18, 12, 18, 18, 0),
    ("host_fold", 8, 10, "all", 5): ("graph", 18, 12, 5, 18, 0),
    ("host_fold", 8, 10, "third", 0): ("graph", 64, 64, 64, 18, 0),
    ("host_fold", 8, 10, "third", 5): ("graph", 64, 64, 64, 18, 0),
    ("host_fold", 8, 10, "twentieth", 0): ("flat", 42),
    ("host_fold", 8, 10, "twentieth", 5): ("flat", 42),
    ("host_fold", 8, 100, "all", 0): ("graph", 108, 100, 108, 108, 0),
    ("host_fold", 8, 100, "all", 5): ("graph", 108, 100, 5, 108, 0),
    ("host_fold", 8, 100, "third", 0): ("graph", 108, 108, 108, 108, 0),
    ("host_fold", 8, 100, "third", 5): ("graph", 108, 108, 108, 108, 0),
    ("host_fold", 8, 100, "twentieth", 0): ("flat", 102),
    ("host_fold", 8, 100, "twentieth", 5): ("flat", 102),
    ("host_fold", 200, 1, "all", 0): ("graph", 200, 12, 200, 9, 0),
    ("host_fold", 200, 1, "all", 5): ("graph", 200, 12, 5, 9, 0),
    ("host_fold", 200, 1, "third", 0): ("graph", 1600, 400, 1600, 9, 0),
    ("host_fold", 200, 1, "third", 5): ("graph", 1600, 400, 1600, 9, 0),
    ("host_fold", 200, 1, "twentieth", 0): ("flat", 33),
    ("host_fold", 200, 1, "twentieth", 5): ("flat", 33),
    ("host_fold", 200, 10, "all", 0): ("graph", 200, 12, 200, 18, 0),
    ("host_fold", 200, 10, "all", 5): ("graph", 200, 12, 5, 18, 0),
    ("host_fold", 200, 10, "third", 0): ("graph", 1600, 400, 1600, 18, 0),
    ("host_fold", 200, 10, "third", 5): ("graph", 1600, 400, 1600, 18, 0),
    ("host_fold", 200, 10, "twentieth", 0): ("flat", 42),
    ("host_fold", 200, 10, "twentieth", 5): ("flat", 42),
    ("host_fold", 200, 100, "all", 0): ("graph", 200, 100, 200, 108, 0),
    ("host_fold", 200, 100, "all", 5): ("graph", 200, 100, 5, 108, 0),
    ("host_fold", 200, 100, "third", 0): ("graph", 1600, 800, 1600, 108, 0),
    ("host_fold", 200, 100, "third", 5): ("graph", 1600, 800, 1600, 108, 0),
    ("host_fold", 200, 100, "twentieth", 0): ("flat", 102),
    ("host_fold", 200, 100, "twentieth", 5): ("flat", 102),
    ("sharded_launch", 0, 1, "all", 0): ("graph", 64, 12, 64, 9, 128),
    ("sharded_launch", 0, 1, "all", 5): ("graph", 64, 12, 5, 9, 128),
    ("sharded_launch", 0, 1, "third", 0): ("graph", 512, 128, 512, 9, 128),
    ("sharded_launch", 0, 1, "third", 5): ("graph", 512, 128, 512, 9, 128),
    ("sharded_launch", 0, 1, "twentieth", 0): ("flat", 9),
    ("sharded_launch", 0, 1, "twentieth", 5): ("flat", 9),
    ("sharded_launch", 0, 10, "all", 0): ("graph", 64, 18, 64, 18, 128),
    ("sharded_launch", 0, 10, "all", 5): ("graph", 64, 18, 5, 18, 128),
    ("sharded_launch", 0, 10, "third", 0): ("graph", 512, 144, 512, 18, 128),
    ("sharded_launch", 0, 10, "third", 5): ("graph", 512, 144, 512, 18, 128),
    ("sharded_launch", 0, 10, "twentieth", 0): ("flat", 18),
    ("sharded_launch", 0, 10, "twentieth", 5): ("flat", 18),
    ("sharded_launch", 0, 100, "all", 0): ("graph", 108, 108, 108, 108, 128),
    ("sharded_launch", 0, 100, "all", 5): ("graph", 108, 108, 5, 108, 128),
    ("sharded_launch", 0, 100, "third", 0): ("graph", 512, 512, 512, 108, 128),
    ("sharded_launch", 0, 100, "third", 5): ("graph", 512, 512, 512, 108, 128),
    ("sharded_launch", 0, 100, "twentieth", 0): ("flat", 108),
    ("sharded_launch", 0, 100, "twentieth", 5): ("flat", 108),
    ("sharded_launch", 8, 1, "all", 0): ("graph", 9, 9, 9, 9, 128),
    ("sharded_launch", 8, 1, "all", 5): ("graph", 9, 9, 5, 9, 128),
    ("sharded_launch", 8, 1, "third", 0): ("graph", 64, 64, 64, 9, 128),
    ("sharded_launch", 8, 1, "third", 5): ("graph", 64, 64, 64, 9, 128),
    ("sharded_launch", 8, 1, "twentieth", 0): ("flat", 9),
    ("sharded_launch", 8, 1, "twentieth", 5): ("flat", 9),
    ("sharded_launch", 8, 10, "all", 0): ("graph", 18, 18, 18, 18, 128),
    ("sharded_launch", 8, 10, "all", 5): ("graph", 18, 18, 5, 18, 128),
    ("sharded_launch", 8, 10, "third", 0): ("graph", 64, 64, 64, 18, 128),
    ("sharded_launch", 8, 10, "third", 5): ("graph", 64, 64, 64, 18, 128),
    ("sharded_launch", 8, 10, "twentieth", 0): ("flat", 18),
    ("sharded_launch", 8, 10, "twentieth", 5): ("flat", 18),
    ("sharded_launch", 8, 100, "all", 0): ("graph", 108, 108, 108, 108, 128),
    ("sharded_launch", 8, 100, "all", 5): ("graph", 108, 108, 5, 108, 128),
    ("sharded_launch", 8, 100, "third", 0): ("graph", 108, 108, 108, 108, 128),
    ("sharded_launch", 8, 100, "third", 5): ("graph", 108, 108, 108, 108, 128),
    ("sharded_launch", 8, 100, "twentieth", 0): ("flat", 108),
    ("sharded_launch", 8, 100, "twentieth", 5): ("flat", 108),
    ("sharded_launch", 200, 1, "all", 0): ("graph", 200, 12, 200, 9, 128),
    ("sharded_launch", 200, 1, "all", 5): ("graph", 200, 12, 5, 9, 128),
    ("sharded_launch", 200, 1, "third", 0): ("graph", 1600, 400, 1600, 9, 128),
    ("sharded_launch", 200, 1, "third", 5): ("graph", 1600, 400, 1600, 9, 128),
    ("sharded_launch", 200, 1, "twentieth", 0): ("flat", 9),
    ("sharded_launch", 200, 1, "twentieth", 5): ("flat", 9),
    ("sharded_launch", 200, 10, "all", 0): ("graph", 200, 18, 200, 18, 128),
    ("sharded_launch", 200, 10, "all", 5): ("graph", 200, 18, 5, 18, 128),
    ("sharded_launch", 200, 10, "third", 0):
        ("graph", 1600, 400, 1600, 18, 128),
    ("sharded_launch", 200, 10, "third", 5):
        ("graph", 1600, 400, 1600, 18, 128),
    ("sharded_launch", 200, 10, "twentieth", 0): ("flat", 18),
    ("sharded_launch", 200, 10, "twentieth", 5): ("flat", 18),
    ("sharded_launch", 200, 100, "all", 0): ("graph", 200, 108, 200, 108, 128),
    ("sharded_launch", 200, 100, "all", 5): ("graph", 200, 108, 5, 108, 128),
    ("sharded_launch", 200, 100, "third", 0):
        ("graph", 1600, 864, 1600, 108, 128),
    ("sharded_launch", 200, 100, "third", 5):
        ("graph", 1600, 864, 1600, 108, 128),
    ("sharded_launch", 200, 100, "twentieth", 0): ("flat", 108),
    ("sharded_launch", 200, 100, "twentieth", 5): ("flat", 108),
    ("grouped_sharded", 0, 1, "all", 0): ("graph", 64, 12, 64, 9, 128),
    ("grouped_sharded", 0, 1, "all", 5): ("graph", 64, 12, 5, 9, 128),
    ("grouped_sharded", 0, 1, "third", 0): ("graph", 64, 12, 64, 9, 128),
    ("grouped_sharded", 0, 1, "third", 5): ("graph", 64, 12, 5, 9, 128),
    ("grouped_sharded", 0, 1, "twentieth", 0): ("graph", 64, 12, 64, 9, 128),
    ("grouped_sharded", 0, 1, "twentieth", 5): ("graph", 64, 12, 5, 9, 128),
    ("grouped_sharded", 0, 10, "all", 0): ("graph", 64, 18, 64, 18, 128),
    ("grouped_sharded", 0, 10, "all", 5): ("graph", 64, 18, 5, 18, 128),
    ("grouped_sharded", 0, 10, "third", 0): ("graph", 64, 18, 64, 18, 128),
    ("grouped_sharded", 0, 10, "third", 5): ("graph", 64, 18, 5, 18, 128),
    ("grouped_sharded", 0, 10, "twentieth", 0): ("graph", 64, 18, 64, 18, 128),
    ("grouped_sharded", 0, 10, "twentieth", 5): ("graph", 64, 18, 5, 18, 128),
    ("grouped_sharded", 0, 100, "all", 0): ("graph", 108, 108, 108, 108, 128),
    ("grouped_sharded", 0, 100, "all", 5): ("graph", 108, 108, 5, 108, 128),
    ("grouped_sharded", 0, 100, "third", 0):
        ("graph", 108, 108, 108, 108, 128),
    ("grouped_sharded", 0, 100, "third", 5): ("graph", 108, 108, 5, 108, 128),
    ("grouped_sharded", 0, 100, "twentieth", 0):
        ("graph", 102, 102, 102, 102, 128),
    ("grouped_sharded", 0, 100, "twentieth", 5):
        ("graph", 102, 102, 5, 102, 128),
    ("grouped_sharded", 8, 1, "all", 0): ("graph", 9, 9, 9, 9, 128),
    ("grouped_sharded", 8, 1, "all", 5): ("graph", 9, 9, 5, 9, 128),
    ("grouped_sharded", 8, 1, "third", 0): ("graph", 9, 9, 9, 9, 128),
    ("grouped_sharded", 8, 1, "third", 5): ("graph", 9, 9, 5, 9, 128),
    ("grouped_sharded", 8, 1, "twentieth", 0): ("graph", 9, 9, 9, 9, 128),
    ("grouped_sharded", 8, 1, "twentieth", 5): ("graph", 9, 9, 5, 9, 128),
    ("grouped_sharded", 8, 10, "all", 0): ("graph", 18, 18, 18, 18, 128),
    ("grouped_sharded", 8, 10, "all", 5): ("graph", 18, 18, 5, 18, 128),
    ("grouped_sharded", 8, 10, "third", 0): ("graph", 18, 18, 18, 18, 128),
    ("grouped_sharded", 8, 10, "third", 5): ("graph", 18, 18, 5, 18, 128),
    ("grouped_sharded", 8, 10, "twentieth", 0): ("graph", 18, 18, 18, 18, 128),
    ("grouped_sharded", 8, 10, "twentieth", 5): ("graph", 18, 18, 5, 18, 128),
    ("grouped_sharded", 8, 100, "all", 0): ("graph", 108, 108, 108, 108, 128),
    ("grouped_sharded", 8, 100, "all", 5): ("graph", 108, 108, 5, 108, 128),
    ("grouped_sharded", 8, 100, "third", 0):
        ("graph", 108, 108, 108, 108, 128),
    ("grouped_sharded", 8, 100, "third", 5): ("graph", 108, 108, 5, 108, 128),
    ("grouped_sharded", 8, 100, "twentieth", 0):
        ("graph", 102, 102, 102, 102, 128),
    ("grouped_sharded", 8, 100, "twentieth", 5):
        ("graph", 102, 102, 5, 102, 128),
    ("grouped_sharded", 200, 1, "all", 0): ("graph", 200, 12, 200, 9, 128),
    ("grouped_sharded", 200, 1, "all", 5): ("graph", 200, 12, 5, 9, 128),
    ("grouped_sharded", 200, 1, "third", 0): ("graph", 200, 12, 200, 9, 128),
    ("grouped_sharded", 200, 1, "third", 5): ("graph", 200, 12, 5, 9, 128),
    ("grouped_sharded", 200, 1, "twentieth", 0):
        ("graph", 200, 12, 200, 9, 128),
    ("grouped_sharded", 200, 1, "twentieth", 5): ("graph", 200, 12, 5, 9, 128),
    ("grouped_sharded", 200, 10, "all", 0): ("graph", 200, 18, 200, 18, 128),
    ("grouped_sharded", 200, 10, "all", 5): ("graph", 200, 18, 5, 18, 128),
    ("grouped_sharded", 200, 10, "third", 0): ("graph", 200, 18, 200, 18, 128),
    ("grouped_sharded", 200, 10, "third", 5): ("graph", 200, 18, 5, 18, 128),
    ("grouped_sharded", 200, 10, "twentieth", 0):
        ("graph", 200, 18, 200, 18, 128),
    ("grouped_sharded", 200, 10, "twentieth", 5):
        ("graph", 200, 18, 5, 18, 128),
    ("grouped_sharded", 200, 100, "all", 0):
        ("graph", 200, 108, 200, 108, 128),
    ("grouped_sharded", 200, 100, "all", 5): ("graph", 200, 108, 5, 108, 128),
    ("grouped_sharded", 200, 100, "third", 0):
        ("graph", 200, 108, 200, 108, 128),
    ("grouped_sharded", 200, 100, "third", 5):
        ("graph", 200, 108, 5, 108, 128),
    ("grouped_sharded", 200, 100, "twentieth", 0):
        ("graph", 200, 102, 200, 102, 128),
    ("grouped_sharded", 200, 100, "twentieth", 5):
        ("graph", 200, 102, 5, 102, 128),
    ("host_fold_sharded", 0, 1, "all", 0): ("graph", 64, 12, 64, 9, 128),
    ("host_fold_sharded", 0, 1, "all", 5): ("graph", 64, 12, 5, 9, 128),
    ("host_fold_sharded", 0, 1, "third", 0): ("graph", 512, 128, 512, 9, 128),
    ("host_fold_sharded", 0, 1, "third", 5): ("graph", 512, 128, 512, 9, 128),
    ("host_fold_sharded", 0, 1, "twentieth", 0): ("flat", 9),
    ("host_fold_sharded", 0, 1, "twentieth", 5): ("flat", 9),
    ("host_fold_sharded", 0, 10, "all", 0): ("graph", 64, 18, 64, 18, 128),
    ("host_fold_sharded", 0, 10, "all", 5): ("graph", 64, 18, 5, 18, 128),
    ("host_fold_sharded", 0, 10, "third", 0):
        ("graph", 512, 144, 512, 18, 128),
    ("host_fold_sharded", 0, 10, "third", 5):
        ("graph", 512, 144, 512, 18, 128),
    ("host_fold_sharded", 0, 10, "twentieth", 0): ("flat", 18),
    ("host_fold_sharded", 0, 10, "twentieth", 5): ("flat", 18),
    ("host_fold_sharded", 0, 100, "all", 0):
        ("graph", 108, 108, 108, 108, 128),
    ("host_fold_sharded", 0, 100, "all", 5): ("graph", 108, 108, 5, 108, 128),
    ("host_fold_sharded", 0, 100, "third", 0):
        ("graph", 512, 512, 512, 108, 128),
    ("host_fold_sharded", 0, 100, "third", 5):
        ("graph", 512, 512, 512, 108, 128),
    ("host_fold_sharded", 0, 100, "twentieth", 0): ("flat", 102),
    ("host_fold_sharded", 0, 100, "twentieth", 5): ("flat", 102),
    ("host_fold_sharded", 8, 1, "all", 0): ("graph", 9, 9, 9, 9, 128),
    ("host_fold_sharded", 8, 1, "all", 5): ("graph", 9, 9, 5, 9, 128),
    ("host_fold_sharded", 8, 1, "third", 0): ("graph", 64, 64, 64, 9, 128),
    ("host_fold_sharded", 8, 1, "third", 5): ("graph", 64, 64, 64, 9, 128),
    ("host_fold_sharded", 8, 1, "twentieth", 0): ("flat", 9),
    ("host_fold_sharded", 8, 1, "twentieth", 5): ("flat", 9),
    ("host_fold_sharded", 8, 10, "all", 0): ("graph", 18, 18, 18, 18, 128),
    ("host_fold_sharded", 8, 10, "all", 5): ("graph", 18, 18, 5, 18, 128),
    ("host_fold_sharded", 8, 10, "third", 0): ("graph", 64, 64, 64, 18, 128),
    ("host_fold_sharded", 8, 10, "third", 5): ("graph", 64, 64, 64, 18, 128),
    ("host_fold_sharded", 8, 10, "twentieth", 0): ("flat", 18),
    ("host_fold_sharded", 8, 10, "twentieth", 5): ("flat", 18),
    ("host_fold_sharded", 8, 100, "all", 0):
        ("graph", 108, 108, 108, 108, 128),
    ("host_fold_sharded", 8, 100, "all", 5): ("graph", 108, 108, 5, 108, 128),
    ("host_fold_sharded", 8, 100, "third", 0):
        ("graph", 108, 108, 108, 108, 128),
    ("host_fold_sharded", 8, 100, "third", 5):
        ("graph", 108, 108, 108, 108, 128),
    ("host_fold_sharded", 8, 100, "twentieth", 0): ("flat", 102),
    ("host_fold_sharded", 8, 100, "twentieth", 5): ("flat", 102),
    ("host_fold_sharded", 200, 1, "all", 0): ("graph", 200, 12, 200, 9, 128),
    ("host_fold_sharded", 200, 1, "all", 5): ("graph", 200, 12, 5, 9, 128),
    ("host_fold_sharded", 200, 1, "third", 0):
        ("graph", 1600, 400, 1600, 9, 128),
    ("host_fold_sharded", 200, 1, "third", 5):
        ("graph", 1600, 400, 1600, 9, 128),
    ("host_fold_sharded", 200, 1, "twentieth", 0): ("flat", 9),
    ("host_fold_sharded", 200, 1, "twentieth", 5): ("flat", 9),
    ("host_fold_sharded", 200, 10, "all", 0): ("graph", 200, 18, 200, 18, 128),
    ("host_fold_sharded", 200, 10, "all", 5): ("graph", 200, 18, 5, 18, 128),
    ("host_fold_sharded", 200, 10, "third", 0):
        ("graph", 1600, 400, 1600, 18, 128),
    ("host_fold_sharded", 200, 10, "third", 5):
        ("graph", 1600, 400, 1600, 18, 128),
    ("host_fold_sharded", 200, 10, "twentieth", 0): ("flat", 18),
    ("host_fold_sharded", 200, 10, "twentieth", 5): ("flat", 18),
    ("host_fold_sharded", 200, 100, "all", 0):
        ("graph", 200, 108, 200, 108, 128),
    ("host_fold_sharded", 200, 100, "all", 5):
        ("graph", 200, 108, 5, 108, 128),
    ("host_fold_sharded", 200, 100, "third", 0):
        ("graph", 1600, 864, 1600, 108, 128),
    ("host_fold_sharded", 200, 100, "third", 5):
        ("graph", 1600, 864, 1600, 108, 128),
    ("host_fold_sharded", 200, 100, "twentieth", 0): ("flat", 102),
    ("host_fold_sharded", 200, 100, "twentieth", 5): ("flat", 102),
}

CASES = [(s, e, k, kp, it) for s in SITES for e in EFS for k in KS
         for kp in KEEPS for it in ITERS]


@pytest.mark.parametrize("site,ef,k,keep,iters", CASES)
def test_route_and_walk_arguments(tables, monkeypatch, site, ef, k, keep,
                                  iters):
    got = capture(tables, monkeypatch, site, ef, k, keep, iters)
    assert got == [EXPECTED[(site, ef, k, keep, iters)]]


# ---------------------------------------------------------------------------
# Projection: the REST route's columns decode to Table.project's rows.
# ---------------------------------------------------------------------------

PROJECT_FIELDS = [
    {"name": "ID", "dataType": "INT", "primaryKey": True},
    {"name": "Tiny", "dataType": "TINYINT"},
    {"name": "Small", "dataType": "SMALLINT"},
    {"name": "Big", "dataType": "BIGINT"},
    {"name": "F", "dataType": "FLOAT"},
    {"name": "D", "dataType": "DOUBLE"},
    {"name": "Flag", "dataType": "BOOL"},
    {"name": "Str", "dataType": "STRING"},
    {"name": "Meta", "dataType": "JSON"},
    {"name": "Geo", "dataType": "GEO_POINT"},
    {"name": "Vec", "dataType": "VECTOR_FLOAT", "dimensions": 4,
     "metricType": "EUCLIDEAN"},
    {"name": "Sp", "dataType": "SPARSE_VECTOR_FLOAT", "dimensions": 50,
     "metricType": "DOT_PRODUCT"},
]


def _decode(col):
    """Row dicts from ColumnarRows' buffers and kind string."""
    rows = [dict() for _ in range(len(col.ids))]
    for name, kind, vals in zip(col.names, col.kinds, col.cols):
        vals = vals.tolist() if isinstance(vals, np.ndarray) else vals
        if kind == "b":
            vals = [bool(v) for v in vals]
        for rec, v in zip(rows, vals):
            rec[name] = v
    if col.dist_buf is not None:
        for rec, d in zip(rows, col.dist_buf.tolist()):
            rec["@distance"] = d
    return rows


@pytest.mark.parametrize("fields,with_distance,ids", [
    ([], True, [3, 0, 7, 5]),
    ([], False, None),
    (["Geo", "Meta", "Sp", "Flag", "F"], True, [6, 1]),
    (["Vec", "Big", "Str", "Tiny", "Small", "D"], True, []),
])
def test_columnar_projection_decodes_to_rows(tables, fields, with_distance,
                                             ids):
    rng = np.random.default_rng(11)
    recs = []
    for i in range(8):
        rec = {"ID": i, "Tiny": i - 4, "Small": 300 * i, "Big": 2**40 + i,
               "F": float(np.float32(rng.normal())), "D": rng.normal(),
               "Flag": i % 3 == 0, "Str": f"s{i}",
               "Geo": {"latitude": 10.5 + i, "longitude": -3.25 * i},
               "Vec": rng.normal(size=4).tolist()}
        rec["Meta"] = {"k": i, "tags": ["a", str(i)]} if i % 2 else None
        rec["Sp"] = ({"indices": [i, i + 7], "values": [0.5, i * 1.0]}
                     if i % 4 else {"indices": [], "values": []})
        recs.append(rec)
    assert vdb.create_table("proj", PROJECT_FIELDS) == 0
    try:
        assert vdb.insert("proj", recs) == 0
        t = vdb._db.databases["routing"].tables["proj"]
        ids = None if ids is None else np.asarray(ids, dtype=np.int64)
        dists = None if ids is None else rng.normal(size=len(ids))
        rows = t.project(fields, ids, with_distance, dists)
        col = t.project_columnar(fields, ids, with_distance, dists)
        assert len(rows) == (8 if ids is None else len(ids))
        assert rows == _decode(col)
        kinds = dict(zip(col.names, col.kinds))
        assert all(kinds[f] == k for f, k in (
            ("Vec", "v"), ("Flag", "b"), ("F", "f"), ("D", "f"),
            ("Big", "i"), ("Tiny", "i"), ("Str", "s"), ("Meta", "o"),
            ("Geo", "o"), ("Sp", "o")) if f in kinds)
    finally:
        assert vdb.drop_table("proj") == 0
