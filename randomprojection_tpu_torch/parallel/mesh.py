"""Device-mesh construction helpers (the port of
``randomprojection_tpu/parallel/mesh.py``).

A JAX mesh names each device once and lets XLA route collectives over it.
The port's ``Mesh`` is a plain layout object: ``axis_names``, ``shape``
(axis → size) and ``devices``, a numpy object array of ``torch.device``
in the mesh's shape.  The sharded serving tier reads a mesh's data axis as
its shard layout (``serving.shard_devices``, ``SimHashIndex(mesh=)``).

Unlike a JAX mesh, a port mesh may name one device more than once: shards
then share that card (one H100 serving eight shards), or the CPU in
tests.  Axes used by the framework:

- ``'data'``    — row parallelism (the reference's Spark partition map)
- ``'feature'`` — contraction-dim sharding; its process groups and
  collectives are the projection half of the scale-out (ROADMAP A10b)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["DATA_AXIS", "FEATURE_AXIS", "Mesh", "default_mesh",
           "make_mesh", "mesh_shape_for"]

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


class Mesh:
    """Devices laid out over named axes.  ``devices`` is a numpy object
    array of ``torch.device`` whose shape follows ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"devices of shape {devices.shape} do not match the axes "
                f"{axis_names}"
            )
        self.devices = devices
        self.axis_names = axis_names

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
