"""K5's share of its roofline: the least time of the traced window's probe
launches (``probe_roofline.k5_bound_s`` a launch, from the shapes the
program counts while the profiler records,
``observability.probe_launches``) over the device time of K5's two CUDA
kernels (``probe_runs_kernel``, ``probe_copy_kernel``), in %.  A program
without the counter, or a window without such a launch, gives None."""

from __future__ import annotations

from rpbench import probe_roofline, trace

KERNELS = ("probe_runs_kernel", "probe_copy_kernel")


def read(ctx):
    try:
        from randomprojection_tpu_torch.utils import observability
    except ImportError:
        return None
    launches = getattr(observability, "probe_launches", None)
    red = ctx.layer.get("trace")
    if launches is None or not red:
        return None
    counted = launches()
    hit = trace.kernel_seconds(red, *KERNELS)
    if not counted or hit is None:
        return None
    bound = sum(probe_roofline.k5_bound_s(*launch) for launch in counted)
    return 100.0 * bound / hit[1]
