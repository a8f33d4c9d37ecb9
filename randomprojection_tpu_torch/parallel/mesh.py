"""Device-mesh construction helpers (the port of
``randomprojection_tpu/parallel/mesh.py``).

A JAX mesh names each device once and lets XLA route collectives over it.
The port's ``Mesh`` is a plain layout object: ``axis_names``, ``shape``
(axis → size), ``devices``, a numpy object array of ``torch.device`` in
the mesh's shape, and ``ranks``, the process that owns each position.
The sharded serving tier reads a mesh's data axis as its shard layout
(``serving.shard_devices``, ``SimHashIndex(mesh=)``); the sharded
projectors (``parallel.sharded``) run each position's block on its device.

Unlike a JAX mesh, a port mesh may name one device more than once: shards
then share that card (one H100 serving eight shards), or the CPU in
tests.  A mesh from ``make_mesh`` is this process's (``ranks`` None);
``global_mesh`` spans every process of a ``torch.distributed`` job, each
process's devices in rank order, as ``jax.devices()`` spans a pod.  Axes
used by the framework:

- ``'data'``    — row parallelism (the reference's Spark partition map)
- ``'feature'`` — contraction-dim sharding, reduced over the feature axis
  (``parallel.sharded``; ``torch.distributed`` groups across processes)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["DATA_AXIS", "FEATURE_AXIS", "Mesh", "default_mesh",
           "global_mesh", "make_mesh", "mesh_shape_for"]

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


class Mesh:
    """Devices laid out over named axes.  ``devices`` is a numpy object
    array of ``torch.device`` whose shape follows ``axis_names``;
    ``ranks``, an int array of the same shape, names the process that owns
    each position (None: every position is this process's)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"devices of shape {devices.shape} do not match the axes "
                f"{axis_names}"
            )
        if ranks is not None and np.shape(ranks) != devices.shape:
            raise ValueError(
                f"ranks of shape {np.shape(ranks)} do not match the devices' "
                f"{devices.shape}"
            )
        self.devices = devices
        self.axis_names = axis_names
        self.ranks = ranks

    def is_local(self, pos: tuple) -> bool:
        """True when this process owns mesh position ``pos``."""
        if self.ranks is None:
            return True
        from randomprojection_tpu_torch.parallel.distributed import process_rank

        return int(self.ranks[pos]) == process_rank()

    def home(self):
        """The device of this process's first position: where a batch
        lands and where a sharded result is assembled."""
        for pos in np.ndindex(*self.devices.shape):
            if self.is_local(pos):
                return self.devices[pos]
        raise ValueError("this process owns no position of the mesh")

    def axis_index(self, pos: tuple, axis: Optional[str]) -> tuple:
        """``(index, size)`` of position ``pos`` along ``axis`` (``(0, 1)``
        for ``None``)."""
        if axis is None:
            return 0, 1
        if axis not in self.axis_names:
            raise ValueError(f"mesh has axes {list(self.axis_names)}, no {axis!r}")
        i = self.axis_names.index(axis)
        return pos[i], self.devices.shape[i]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def _local_devices() -> list:
    """Every CUDA card of this process; raises when there is none."""
    import torch

    from randomprojection_tpu_torch.backends.torch_backend import resolve_device

    resolve_device(None, how="devices=['cpu']")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def concrete_device(device, how: str = "device='cpu'"):
    """``device`` checked (None: the card, raising with none, ``how``
    naming the way to ask for the CPU), an index-less ``'cuda'`` made the
    current card, so a thread can pin it."""
    import torch

    from randomprojection_tpu_torch.backends.torch_backend import resolve_device

    dev = resolve_device(device, how=how)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_devices(devices: Sequence) -> list:
    """Each entry as a checked, concrete ``torch.device``."""
    return [concrete_device(d, how="devices=['cpu']") for d in devices]


def make_mesh(axis_sizes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``Mesh`` from ``{axis_name: size}``.

    Sizes must multiply to the device count (pass ``devices`` to use a
    subset, or to name one device several times).  Axis order follows dict
    order.  With no ``devices`` the mesh spans every CUDA card."""
    devices = resolve_devices(devices) if devices is not None else _local_devices()
    total = 1
    for s in axis_sizes.values():
        total *= s
    if total != len(devices):
        raise ValueError(
            f"Mesh axes {axis_sizes} require {total} devices, have {len(devices)}"
        )
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(axis_sizes.values())), tuple(axis_sizes))


def global_mesh(axis_sizes: dict, local_devices: Optional[Sequence] = None
                ) -> Mesh:
    """A mesh over every process of the ``torch.distributed`` job (after
    ``distributed.initialize()``): each process's ``local_devices`` (every
    CUDA card of this process by default) gathered in rank order, each
    position's owning rank recorded.  Collective: every process calls it
    with the same ``axis_sizes``.  NCCL refuses two ranks on one card, so
    under an ``nccl`` job two processes of one host naming the same card
    raise (use gloo there)."""
    import socket

    import torch.distributed as dist

    from randomprojection_tpu_torch.parallel.distributed import (
        is_multi_process,
    )

    local = (resolve_devices(local_devices) if local_devices is not None
             else _local_devices())
    if not is_multi_process():
        return make_mesh(axis_sizes, local)
    mine = (socket.gethostname(), [str(d) for d in local])
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    if dist.get_backend() == "nccl":
        seen = {}
        for rank, (host, devs) in enumerate(everyone):
            for d in devs:
                other = seen.setdefault((host, d), rank)
                if other != rank:
                    raise ValueError(
                        f"ranks {other} and {rank} both name {d} on {host}; "
                        "NCCL refuses two ranks on one card: initialize "
                        "with backend='gloo'"
                    )
    import torch

    devices = [torch.device(d) for _, devs in everyone for d in devs]
    ranks = [r for r, (_, devs) in enumerate(everyone) for _ in devs]
    mesh = make_mesh(axis_sizes, devices)
    return Mesh(mesh.devices, mesh.axis_names,
                np.asarray(ranks, dtype=np.int64).reshape(mesh.devices.shape))


def mesh_shape_for(n_devices: int, feature_shards: int = 1) -> dict:
    """Default mesh factorization: all devices on 'data' unless TP requested."""
    if n_devices % feature_shards:
        raise ValueError(
            f"feature_shards={feature_shards} must divide n_devices={n_devices}"
        )
    shape = {DATA_AXIS: n_devices // feature_shards}
    if feature_shards > 1:
        shape[FEATURE_AXIS] = feature_shards
    return shape


def default_mesh(n_devices: Optional[int] = None, feature_shards: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A ready mesh over the first ``n_devices`` devices (default: all):
    every CUDA card unless ``devices`` are given, raising with no card."""
    devices = resolve_devices(devices) if devices is not None else _local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return make_mesh(mesh_shape_for(len(devices), feature_shards), devices)


def data_axis_devices(mesh: Mesh, data_axis: str = DATA_AXIS) -> list:
    """One device per ``data_axis`` index: where the mesh has other axes
    too, the first device of each data-axis slice."""
    names = list(mesh.axis_names)
    if data_axis not in names:
        raise ValueError(
            f"mesh has axes {names}, no {data_axis!r} axis to shard rows over"
        )
    arr = np.moveaxis(np.asarray(mesh.devices), names.index(data_axis), 0)
    arr = arr.reshape(arr.shape[0], -1)
    return [row[0] for row in arr]
