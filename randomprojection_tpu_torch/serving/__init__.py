"""The sharded serving tier of the port (``randomprojection_tpu/serving``).

``ShardedSimHashIndex`` row-shards a SimHash corpus over shard devices
(global int64 ids, int32 ids a shard, one cross-shard merge a query
tile); ``ShardedTopKServer`` routes coalesced request batches round-robin
across replica groups.  See ``sharded_index.py`` for the id space and the
merge order.
"""

from randomprojection_tpu_torch.serving.server import ShardedTopKServer
from randomprojection_tpu_torch.serving.sharded_index import (
    ShardedSimHashIndex,
    shard_devices,
)

__all__ = ["ShardedSimHashIndex", "ShardedTopKServer", "shard_devices"]
