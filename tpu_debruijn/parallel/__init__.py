"""Multi-chip distribution: MSP buckets mapped onto a jax device mesh.

The reference's only scale-out mechanism is minimum-substring-partition
sharding — callers split reads into minimizer intervals keyed by bucket id
and process buckets independently (/root/reference/src/msp.rs,
src/filter.rs:238-276, driver test src/test.rs:418-504).  Here that
becomes a first-class SPMD pipeline:

* reads are data-parallel over a 1-D ``Mesh`` axis ("shards"),
* each device scans its reads (vectorized MSP), assigns every interval to
  ``bucket mod n_shards``, and exchanges interval substrings with an
  ``all_to_all`` over the device interconnect (NVLink between the GPUs of
  one host),
* each device counts/filters its buckets' kmers locally (exact global
  counts — MSP guarantees every occurrence of a kmer lands in one bucket),
* shard unitig graphs are combined and re-compressed globally
  (BaseGraph::combine + compress_graph semantics, graph.rs:71-101,
  compression.rs:291-349).
"""

from tpu_debruijn.parallel.mesh import make_mesh, shard_axis
from tpu_debruijn.parallel.shard import (
    ShardPlan,
    assemble_sharded,
    sharded_count_step,
    sharded_tables,
)

__all__ = [
    "make_mesh",
    "shard_axis",
    "ShardPlan",
    "assemble_sharded",
    "sharded_count_step",
    "sharded_tables",
]
