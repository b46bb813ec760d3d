"""tpusdr_torch.parallel: the sharded streams (port of tpusdr/parallel).

Two shardings over a mesh (``parallel/mesh.py``: one process on one
device, or a ``torch.distributed`` process group):

  * time-block sharding (``halo.py``): a tick split into S shards, each
    warmed by an overlap-save halo of its left neighbour's last samples;
  * channel sharding (``channels.py``): the channelizer's output pivoted
    by one all-to-all into channel-sharded streams whose demod state
    stays with its shard.

``ingest.py`` reads each process's byte ranges of a capture.
"""

from tpusdr_torch.parallel.channels import ChannelShardedBank  # noqa: F401
from tpusdr_torch.parallel.halo import TimeShardedStream  # noqa: F401
from tpusdr_torch.parallel.mesh import make_mesh  # noqa: F401
