"""Scale-out of the port: the device mesh, sharded projection and
multi-process bring-up (the port of ``randomprojection_tpu/parallel``).

The sharded serving tier reads a mesh's data axis as its shard layout; the
sharded projectors run each mesh position's block on its device and reduce
over the feature axis, across processes with ``torch.distributed``.
"""

from randomprojection_tpu_torch.parallel import distributed
from randomprojection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    Mesh,
    default_mesh,
    global_mesh,
    make_mesh,
    mesh_shape_for,
)
from randomprojection_tpu_torch.parallel.sharded import (
    make_sharded_projector,
    materialize_sharded,
    replicated,
    row_bucket,
    row_sharded,
)

__all__ = [
    "distributed",
    "default_mesh",
    "make_mesh",
    "mesh_shape_for",
    "make_sharded_projector",
    "materialize_sharded",
    "replicated",
    "row_sharded",
    "DATA_AXIS",
    "FEATURE_AXIS",
    "Mesh",
    "global_mesh",
    "row_bucket",
]
