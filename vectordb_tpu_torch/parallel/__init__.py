from .sharded import (Mesh, make_mesh, sharded_flat_topk, sharded_beam_search,
                      sharded_knn_round, ShardedTable)
from .engine import (ShardedDenseField, ShardedGraphIndex,
                     ShardedVectorStore, get_engine_mesh, set_engine_mesh)

__all__ = ["Mesh", "make_mesh", "sharded_flat_topk", "sharded_beam_search",
           "sharded_knn_round", "ShardedTable", "ShardedDenseField",
           "ShardedGraphIndex", "ShardedVectorStore", "get_engine_mesh",
           "set_engine_mesh"]
