"""How full K4's tensor-core scan keeps the card over the traced window:
the blocks of its launches (``topk_mma_kernel``, one block an SM) over the
block slots of their waves, ``ceil(blocks / SMs) · SMs`` a launch, as the
program counts them while the profiler records
(``observability.launch_waves``), in %.  A program without the counter,
or a window with no such launch, gives None (the name's part after the
dot names the end-to-end metric it moves: ``k4_wave_fill.serve``)."""

from __future__ import annotations

KERNEL = "topk_mma_kernel"


def read(ctx):
    try:
        from randomprojection_tpu_torch.utils import observability
    except ImportError:
        return None
    waves = getattr(observability, "launch_waves", None)
    got = waves().get(KERNEL) if waves is not None else None
    if not got or got[2] <= 0:
        return None
    _launches, blocks, slots = got
    return 100.0 * blocks / slots
