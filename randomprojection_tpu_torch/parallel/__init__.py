"""Scale-out helpers of the port (single-device row bucketing so far)."""

from randomprojection_tpu_torch.parallel.sharded import row_bucket

__all__ = ["row_bucket"]
