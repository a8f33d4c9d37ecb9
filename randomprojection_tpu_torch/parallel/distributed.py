"""Multi-process bring-up (the port of
``randomprojection_tpu/parallel/distributed.py``).

The reference joins one process per host into one JAX runtime with
``jax.distributed.initialize()``, and XLA's collectives cross the hosts.
The port's processes join one ``torch.distributed`` job:
``initialize()`` wraps ``init_process_group``, ``mesh.global_mesh``
gathers every process's devices into one mesh that records which rank owns
each position, and a reduction whose positions lie in several processes
runs one ``all_reduce`` over a group made once by ``new_group``
(``process_groups``).

The collective backend: gloo wherever two ranks share a card, and on the
CPU (NCCL refuses two ranks on one GPU); NCCL only where each rank owns a
card (``initialize(backend='nccl')``).  The installed gloo's
``all_reduce`` takes CUDA tensors as they are (read on an H100,
``torch_experiments/gloo_cuda.py``; PERF.md, PR 14), so a partial on the
card goes to the collective with no host staging of the port's own.

Typical use, one process per host, every process running the same code::

    from randomprojection_tpu_torch.parallel import distributed

    distributed.initialize()            # no-op on single-process runs
    lo, hi = distributed.host_row_range(n_rows)
    est = SparseRandomProjection(256, random_state=0).fit_schema(n_rows, d)
    for lo_b, y in est.transform_stream(my_source_over(lo, hi)): ...

Rows are independent in X·Rᵀ and the matrix is a function of the seed, so
each process streams its own rows with no communication at all.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

__all__ = ["initialize", "is_multi_process", "host_row_range",
           "process_rank", "world_size", "process_groups"]

#: env vars whose presence means "this process was launched as part of a
#: distributed job" — if joining then fails, that is a misconfiguration to
#: surface, not a single-machine run to degrade to: the reference's markers
#: and torch's own launcher's
_DISTRIBUTED_ENV_MARKERS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES",
    "JAX_PROCESS_ID",
    "MASTER_ADDR",
    "WORLD_SIZE",
    "RANK",
    "TORCHELASTIC_RUN_ID",
)

def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "gloo",
) -> None:
    """Join the multi-process job; a no-op for single-process runs.

    ``coordinator_address`` (``host:port``, process 0 listens there),
    ``num_processes`` and ``process_id`` set the job up by hand; with none
    of them, ``init_process_group`` reads torch's launcher environment
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``).  ``backend`` is gloo by
    default (two ranks may share a card, and the CPU takes it); ``'nccl'``
    only where each rank owns a card.  Idempotent.

    Failure policy (the reference's): an error is swallowed ONLY when
    nothing indicates a distributed launch (no explicit arguments, no
    launcher env vars) — the ordinary single-machine case.  Any explicit
    argument, or a launcher env marker, makes failure fatal: silently
    degrading a real job to one process would compute 1/Nth of the work
    while claiming success.
    """
    import torch.distributed as dist

    if getattr(initialize, "_done", False) or dist.is_initialized():
        initialize._done = True
        return
    explicit = (
        coordinator_address is not None
        or process_id is not None
        or num_processes not in (None, 1)
    )
    try:
        if explicit:
            address = coordinator_address or ""
            if "://" not in address:
                address = f"tcp://{address}"
            dist.init_process_group(
                backend, init_method=address, world_size=num_processes,
                rank=process_id,
            )
        else:
            dist.init_process_group(backend, init_method="env://")
        initialize._done = True
    except (ValueError, RuntimeError) as e:
        markers = [v for v in _DISTRIBUTED_ENV_MARKERS if os.environ.get(v)]
        if explicit or markers:
            raise RuntimeError(
                "torch.distributed.init_process_group failed for what looks "
                f"like a distributed launch (explicit args={explicit}, env "
                f"markers={markers}); refusing to silently degrade to "
                "single-process"
            ) from e
        initialize._done = True
        logging.getLogger("randomprojection_tpu_torch").debug(
            "torch.distributed.init_process_group skipped: %s", e
        )


def is_multi_process() -> bool:
    return world_size() > 1


def _joined() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_rank() -> int:
    """This process's rank in the job (0 outside one)."""
    import torch.distributed as dist

    return dist.get_rank() if _joined() else 0


def world_size() -> int:
    """The job's process count (1 outside one)."""
    import torch.distributed as dist

    return dist.get_world_size() if _joined() else 1


def host_row_range(
    n_rows: int,
    *,
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[int, int]:
    """This process's contiguous row slice ``[lo, hi)`` of a global stream.

    Rows are independent in X·Rᵀ, so the natural multi-process
    decomposition is block-by-process (the Spark partition map's
    equivalent).  The split is balanced to within one row and every process
    computes it without communication.  ``process_id``/``process_count``
    default to the live job's values; passing them makes the function pure
    (tests, offline planning).
    """
    if n_rows < 0:
        raise ValueError(f"n_rows must be non-negative, got {n_rows}")
    if (process_id is None) != (process_count is None):
        # a half-specified pair silently overridden by the live job would
        # return a wrong partition plan with no error
        raise ValueError(
            "pass process_id and process_count together (or neither, to "
            "use the live job's values)"
        )
    if process_id is None:
        process_id, process_count = process_rank(), world_size()
    if not 0 <= process_id < process_count:
        raise ValueError(
            f"process_id {process_id} out of range for {process_count} processes"
        )
    base, extra = divmod(n_rows, process_count)
    lo = process_id * base + min(process_id, extra)
    hi = lo + base + (1 if process_id < extra else 0)
    return lo, hi


def process_groups(mesh, axis: str) -> dict:
    """The groups of ``mesh``'s reductions over ``axis``: for every set of
    several ranks that own the positions of one slice along ``axis``, one
    ``torch.distributed`` group, keyed by the sorted rank tuple and made
    once a mesh.  ``new_group`` is collective: every process makes every
    group, in the same order (the mesh's own), even the groups it is not
    in.  Empty for a mesh of this process alone."""
    import numpy as np

    if mesh.ranks is None:
        return {}
    import torch.distributed as dist

    groups = mesh.__dict__.setdefault("_process_groups", {})
    i = mesh.axis_names.index(axis)
    slices = np.moveaxis(np.asarray(mesh.ranks), i, -1).reshape(
        -1, mesh.ranks.shape[i])
    for row in slices:
        ranks = tuple(sorted(set(int(r) for r in row)))
        if len(ranks) > 1 and ranks not in groups:
            groups[ranks] = dist.new_group(list(ranks))
    return groups
