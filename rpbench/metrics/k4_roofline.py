"""K4's share of its roofline: the least time the exact top-m of the traced
window's query tiles can take (``roofline.k4_bound_s`` a tile) over the
device time of the kernels that do it, ``rp_fused_topk``'s scan and its
merge (CUDA kernels ``topk_mma_kernel`` or ``topk_scan_kernel``, and
``topk_merge_kernel``), in %."""

from __future__ import annotations

from rpbench import roofline, trace

KERNELS = ("topk_mma_kernel", "topk_scan_kernel", "topk_merge_kernel")


def read(ctx):
    red, k4 = ctx.layer.get("trace"), ctx.layer.get("k4")
    if not red or not k4:
        return None
    hit = trace.kernel_seconds(red, *KERNELS)
    if hit is None:
        return None
    bound = sum(count * roofline.k4_bound_s(nq, k4["n_codes"], k4["n_bytes"],
                                            k4["m"])
                for nq, count in k4["tiles"])
    return 100.0 * bound / hit[1]
