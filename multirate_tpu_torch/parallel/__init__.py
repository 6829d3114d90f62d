"""Distribution layer: channel (DP) x time-block (SP) sharding over a mesh
of ranks.

Counterpart of ``multirate_tpu/parallel``. The reference is
single-threaded (SURVEY.md section 2: no parallelism of any kind); this
layer shards independent channels and time blocks across the ranks of a
``torch.distributed`` process group, exchanges the ``h_min``-sample
history tails at block boundaries (an overlap-save halo, point to point
over the mesh's ``"t"`` dim), and computes each block's entry phase state
in closed form on the host, so blocks are independent after one halo
exchange: no sequential scan across ranks.
"""

from .sharded import (
    make_mesh, shard_filt_block, shard_filt, sharded_resample, compact,
)
from .multihost import initialize, is_multihost, local_data_slice

__all__ = ["make_mesh", "shard_filt_block", "shard_filt", "sharded_resample",
           "compact", "initialize", "is_multihost", "local_data_slice"]
