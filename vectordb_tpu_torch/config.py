"""Global engine configuration with live reconfiguration.

Mirrors the semantics of the reference's global `Config` of validated atomics
(reference config/config.hpp:17-89): the same keys are accepted by
`update_config`, and it reports whether running query state must be swapped.

The keys are those of vectordb_tpu.config, so one update_config payload works
for both engines. This package reads the ones that steer its paths: the
query path (MasterQueueSize, PreFilter, WalTextFormat, ShardCount (>= 2
shards the dense fields, parallel/), QueryBatchWindowMs, DeviceRerank,
DeviceRerankMaxBytes, QueryGroupSize, QueryDtype, FlatServe,
FlatServeMaxRows, RebuildIntervalSeconds) and the graph index
(MinimalGraphSize, SearchEf, BruteForceThreshold, GraphKnnK, GraphDegree,
GraphAlpha, Beam*, IvfKnnThreshold, IvfProbes, WarmupBuckets, BuildSearch*,
FusedTraversal, FusedMaxBytes, AutoTuneSearch, AutoTuneTargetRecall). The
others are accepted and kept only: the TPU relay's pools (DispatchAhead,
UploadThreads, DrainThreads), DeviceHbmBytes (the port asks the card for
its free memory), UseBf16Matmul, and the reference's executor and queue
knobs that neither engine reads (IntraQueryThreads, LocalQueueSize,
GlobalSyncInterval, NumExecutorPerField, RebuildThreads).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Tuple


class Config:
    def __init__(self):
        self._lock = threading.Lock()
        # Defaults follow reference config.hpp:18-26.
        self.intra_query_threads = 4
        self.master_queue_size = 500
        self.local_queue_size = 500
        self.global_sync_interval = 15
        self.minimal_graph_size = 100
        self.num_executor_per_field = 16
        self.rebuild_threads = 1
        self.pre_filter = False
        # Engine knobs with no reference analogue (same defaults as
        # vectordb_tpu; see vectordb_tpu/config.py for what each steers).
        self.search_ef = 64
        # Accumulation window for coalescing concurrent single queries
        # (batcher.py; server mode only).
        self.query_batch_window_ms = 2.0
        self.use_bf16_matmul = True
        self.brute_force_threshold = 512   # reference vec_search_executor.hpp:28
        self.rebuild_interval_s = 60.0     # reference db_server.hpp:21
        self.graph_knn_k = 64
        self.graph_degree = 32
        self.graph_alpha = 1.2
        self.beam_expand = 4
        self.beam_term_width = 12
        self.beam_traversal_degree = 48
        self.beam_iters = 0
        self.beam_compact = 96
        # Write WAL insert entries as the reference's JSON-text lines
        # instead of binary column batches (slower; for interop).
        self.wal_text_format = False
        # Sharded data plane (parallel/): >= 2 shards each dense field over
        # the engine mesh (that many cards, or set_engine_mesh's).
        self.shard_count = 0
        self.ivf_knn_threshold = 3_000_000
        self.ivf_probes = 0
        self.warmup_buckets = 16
        self.build_search_l = 0
        self.build_search_iters = 0
        # On-device exact f32 re-rank of flat-serve candidates ("auto" |
        # "on" | "off"): auto keeps an f32 copy of the table on the device
        # while it fits device_rerank_max_bytes and the free device memory;
        # "off" re-ranks on the host mirror.
        self.device_rerank = "auto"
        self.device_rerank_max_bytes = 8 << 30
        # Throughput mode: up to this many query batches go through one
        # flat-serve program. 1 = one batch per program.
        self.query_group_size = 4
        self.dispatch_ahead = 2
        self.upload_threads = 4
        self.drain_threads = 2
        self.fused_traversal = "auto"
        self.fused_max_bytes = 12 << 30
        # Device memory for backends that report none; the port reads the
        # card's own size (torch.cuda.mem_get_info) and ignores this.
        self.device_hbm_bytes = 16 << 30
        self.auto_tune_search = True
        self.auto_tune_target_recall = 0.995
        # Query wire of the grouped paths (ops/qwire): "f32" | "bf16" |
        # "int8" | "auto" (the wire tune_search_ef validated, else f32).
        self.query_dtype = "auto"
        # Flat-serve ("auto" | "on" | "off"): serve throughput batches from
        # a whole-table partial-min scan + exact f32 re-rank when the table
        # has at most FlatServeMaxRows rows. "on" ignores the row gate (the
        # structural gates still apply); "off" never flat-serves.
        self.flat_serve = "auto"
        self.flat_serve_max_rows = 262144
        self.build_search_pools = "auto"

    # key -> (attribute, converter, validator-or-None, requires_swap).
    # Declarative so update() can validate EVERY key before applying any:
    # a rejected multi-key payload must leave the config untouched.
    _KEYS = {
        "IntraQueryThreads": ("intra_query_threads", int,
                              lambda v: 1 <= v <= 128, True),
        "ConcurrentWorkersPerVectorIndex": ("num_executor_per_field", int,
                                            lambda v: 1 <= v <= 1024, True),
        "NumExecutorPerField": ("num_executor_per_field", int,
                                lambda v: 1 <= v <= 1024, True),
        "MasterQueueSize": ("master_queue_size", int,
                            lambda v: 1 <= v <= 16000, True),
        "LocalQueueSize": ("local_queue_size", int,
                           lambda v: 1 <= v <= 16000, True),
        "GlobalSyncInterval": ("global_sync_interval", int,
                               lambda v: 1 <= v <= 1000, True),
        "MinimalGraphSize": ("minimal_graph_size", int,
                             lambda v: 1 <= v <= 1_000_000, False),
        "RebuildThreads": ("rebuild_threads", int,
                           lambda v: 1 <= v <= 128, False),
        "PreFilter": ("pre_filter", bool, None, False),
        "SearchEf": ("search_ef", int, lambda v: 1 <= v <= 16000, False),
        "UseBf16Matmul": ("use_bf16_matmul", bool, None, False),
        "BruteForceThreshold": ("brute_force_threshold", int, None, False),
        "RebuildIntervalSeconds": ("rebuild_interval_s", float, None, False),
        "GraphKnnK": ("graph_knn_k", int, lambda v: 4 <= v <= 512, False),
        "GraphDegree": ("graph_degree", int, lambda v: 4 <= v <= 256, False),
        "GraphAlpha": ("graph_alpha", float,
                       lambda v: 1.0 <= v <= 2.0, False),
        "BeamExpand": ("beam_expand", int, lambda v: 1 <= v <= 32, False),
        "WalTextFormat": ("wal_text_format", bool, None, False),
        "BeamIters": ("beam_iters", int, lambda v: 0 <= v <= 16000, False),
        "BeamTermWidth": ("beam_term_width", int,
                          lambda v: 0 <= v <= 16000, False),
        "BeamTraversalDegree": ("beam_traversal_degree", int,
                                lambda v: 0 <= v <= 512, False),
        "BeamCompact": ("beam_compact", int,
                        lambda v: 0 <= v <= 4096, False),
        "ShardCount": ("shard_count", int, lambda v: 0 <= v <= 4096, False),
        "QueryBatchWindowMs": ("query_batch_window_ms", float,
                               lambda v: 0.0 <= v <= 1000.0, False),
        "IvfKnnThreshold": ("ivf_knn_threshold", int,
                            lambda v: 10_000 <= v <= 1_000_000_000, False),
        "IvfProbes": ("ivf_probes", int,
                      lambda v: 0 <= v <= 1024, False),
        "WarmupBuckets": ("warmup_buckets", int,
                          lambda v: 0 <= v <= 4096, False),
        # 0 = auto (index.graph resolves the measured policy).
        "BuildSearchL": ("build_search_l", int,
                         lambda v: v == 0 or 8 <= v <= 1024, False),
        "BuildSearchIters": ("build_search_iters", int,
                             lambda v: v == 0 or 1 <= v <= 256, False),
        "BuildSearchPools": ("build_search_pools", str,
                             lambda v: v in ("auto", "on", "off"), False),
        "DeviceRerank": ("device_rerank", str,
                         lambda v: v in ("auto", "on", "off"), False),
        "DeviceRerankMaxBytes": ("device_rerank_max_bytes", int,
                                 lambda v: 0 <= v <= (1 << 40), False),
        "QueryGroupSize": ("query_group_size", int,
                           lambda v: 1 <= v <= 64, False),
        "DispatchAhead": ("dispatch_ahead", int,
                          lambda v: 1 <= v <= 16, False),
        "UploadThreads": ("upload_threads", int,
                          lambda v: 0 <= v <= 8, False),
        "DrainThreads": ("drain_threads", int,
                         lambda v: 0 <= v <= 8, False),
        "FusedTraversal": ("fused_traversal", str,
                           lambda v: v in ("auto", "on", "off"), False),
        "FusedMaxBytes": ("fused_max_bytes", int,
                          lambda v: 0 <= v <= (1 << 40), False),
        "DeviceHbmBytes": ("device_hbm_bytes", int,
                           lambda v: 0 <= v <= (1 << 44), False),
        "QueryDtype": ("query_dtype", str,
                       lambda v: v in ("auto", "f32", "bf16", "int8"),
                       False),
        "AutoTuneSearch": ("auto_tune_search", bool, None, False),
        "AutoTuneTargetRecall": ("auto_tune_target_recall", float,
                                 lambda v: 0.5 <= v <= 1.0, False),
        "FlatServe": ("flat_serve", str,
                      lambda v: v in ("auto", "on", "off"), False),
        "FlatServeMaxRows": ("flat_serve_max_rows", int,
                             lambda v: 0 <= v <= (1 << 31), False),
    }

    def update(self, cfg: Dict[str, Any]) -> Tuple[bool, bool]:
        """Apply a JSON config update.

        Returns (ok, swap_required) mirroring reference `updateConfig`
        (config.hpp:65-85): swap_required is True when executor-level state
        (queue sizes / thread counts) changed. Transactional: every key is
        validated before any is applied, so a rejected payload leaves the
        config unchanged.
        """
        with self._lock:
            staged = []  # (attr, value, requires_swap)
            for key, raw in cfg.items():
                spec = self._KEYS.get(key)
                if spec is None:
                    continue  # unknown keys ignored, like the reference
                attr, conv, check, needs_swap = spec
                v = conv(raw)
                if check is not None and not check(v):
                    return False, False
                staged.append((attr, v, needs_swap))
            swap = False
            for attr, v, needs_swap in staged:
                if needs_swap and getattr(self, attr) != v:
                    swap = True
                setattr(self, attr, v)
        return True, swap

    def to_dict(self) -> Dict[str, Any]:
        return {
            "IntraQueryThreads": self.intra_query_threads,
            "ConcurrentWorkersPerVectorIndex": self.num_executor_per_field,
            "MasterQueueSize": self.master_queue_size,
            "LocalQueueSize": self.local_queue_size,
            "GlobalSyncInterval": self.global_sync_interval,
            "MinimalGraphSize": self.minimal_graph_size,
            "RebuildThreads": self.rebuild_threads,
            "PreFilter": self.pre_filter,
            "SearchEf": self.search_ef,
            "UseBf16Matmul": self.use_bf16_matmul,
            "BruteForceThreshold": self.brute_force_threshold,
            "RebuildIntervalSeconds": self.rebuild_interval_s,
            "GraphKnnK": self.graph_knn_k,
            "GraphDegree": self.graph_degree,
            "GraphAlpha": self.graph_alpha,
            "BeamExpand": self.beam_expand,
            "WalTextFormat": self.wal_text_format,
            "BeamIters": self.beam_iters,
            "BeamTermWidth": self.beam_term_width,
            "BeamTraversalDegree": self.beam_traversal_degree,
            "BeamCompact": self.beam_compact,
            "ShardCount": self.shard_count,
            "IvfKnnThreshold": self.ivf_knn_threshold,
            "IvfProbes": self.ivf_probes,
            "WarmupBuckets": self.warmup_buckets,
            "QueryBatchWindowMs": self.query_batch_window_ms,
            "BuildSearchL": self.build_search_l,
            "BuildSearchIters": self.build_search_iters,
            "BuildSearchPools": self.build_search_pools,
            "DeviceRerank": self.device_rerank,
            "DeviceRerankMaxBytes": self.device_rerank_max_bytes,
            "QueryGroupSize": self.query_group_size,
            "DispatchAhead": self.dispatch_ahead,
            "UploadThreads": self.upload_threads,
            "DrainThreads": self.drain_threads,
            "FusedTraversal": self.fused_traversal,
            "FusedMaxBytes": self.fused_max_bytes,
            "DeviceHbmBytes": self.device_hbm_bytes,
            "QueryDtype": self.query_dtype,
            "AutoTuneSearch": self.auto_tune_search,
            "AutoTuneTargetRecall": self.auto_tune_target_recall,
            "FlatServe": self.flat_serve,
            "FlatServeMaxRows": self.flat_serve_max_rows,
        }


# Global config instance, like the reference's `globalConfig`.
global_config = Config()
