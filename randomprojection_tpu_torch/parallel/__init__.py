"""Scale-out helpers of the port: the device mesh and row bucketing.

The serving half of the scale-out (the sharded index tier) reads a mesh's
data axis as its shard layout; the projection half (process groups,
collectives, ``make_sharded_projector``) is ROADMAP A10b.
"""

from randomprojection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    Mesh,
    default_mesh,
    make_mesh,
    mesh_shape_for,
)
from randomprojection_tpu_torch.parallel.sharded import row_bucket

__all__ = ["DATA_AXIS", "FEATURE_AXIS", "Mesh", "default_mesh", "make_mesh",
           "mesh_shape_for", "row_bucket"]
