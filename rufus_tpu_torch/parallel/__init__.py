"""The sharded chain over a mesh of shards (``sharded.py``)."""

from ..ops.table import make_splitters
from .sharded import (ShardMesh, ShardedKmerTable, all_gather, all_to_all,
                      local_count_step, make_mesh, owners_by_splitters,
                      query_counts, replicate, replicate_hashlist,
                      segment_bounds, sharded_filter_step,
                      sharded_query_multi, sharded_subtract_step)

__all__ = ["ShardMesh", "ShardedKmerTable", "all_gather", "all_to_all",
           "local_count_step", "make_mesh", "make_splitters",
           "owners_by_splitters", "query_counts", "replicate",
           "replicate_hashlist", "segment_bounds", "sharded_filter_step",
           "sharded_query_multi", "sharded_subtract_step"]
