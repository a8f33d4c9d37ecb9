"""K1's share of its roofline: the least time the lazy projection of the
traced window's rows can take (``roofline.k1_bound_s``) over the device
time of the kernels that do it, ``rp_fused_project``'s product and its
mask cache (CUDA kernels ``fused_project_kernel`` and
``mask_writer_kernel``), in %."""

from __future__ import annotations

from rpbench import roofline, trace

KERNELS = ("fused_project_kernel", "mask_writer_kernel")


def read(ctx):
    red, k1 = ctx.layer.get("trace"), ctx.layer.get("k1_rows")
    if not red or not k1:
        return None
    hit = trace.kernel_seconds(red, *KERNELS)
    if hit is None:
        return None
    bound = roofline.k1_bound_s(k1["rows"], k1["d"], k1["k"], k1["density"])
    return 100.0 * bound / hit[1]
