"""The sharded chain over a mesh of shards (``sharded.py``), on one process
or over the processes of a torch.distributed group (``process.py``)."""

from ..ops.table import make_splitters
from .process import make_process_mesh
from .sharded import (ShardMesh, ShardedKmerTable, all_gather, all_max,
                      all_to_all, exchange, local_count_step, local_rows,
                      make_mesh, mesh_splitters, owners_by_splitters,
                      query_counts, replicate, replicate_hashlist,
                      segment_bounds, sharded_filter_step,
                      sharded_query_multi, sharded_query_step,
                      sharded_subtract_step)

__all__ = ["ShardMesh", "ShardedKmerTable", "all_gather", "all_max",
           "all_to_all", "exchange", "local_count_step", "local_rows",
           "make_mesh", "make_process_mesh", "make_splitters",
           "mesh_splitters", "owners_by_splitters", "query_counts",
           "replicate", "replicate_hashlist", "segment_bounds",
           "sharded_filter_step", "sharded_query_multi",
           "sharded_query_step", "sharded_subtract_step"]
