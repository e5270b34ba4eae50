"""Device meshes for data-parallel SNN execution (port of
``repro.parallel.mesh``).

A mesh here is a :class:`DataMesh`: an immutable tuple of devices with one
axis, ``"data"``, that the batch is split over. Its ``shape`` is
``{"data": len(devices)}``, the mapping ``sharding.resolver`` reads, so the
resolver's divisibility rule applies to it unchanged.

- :func:`data_mesh` takes the first ``n`` distinct visible CUDA devices
  and caches the mesh per device tuple, so the runner caches keyed on it
  stay stable.
- A *virtual* mesh names a device more than once, e.g.
  ``DataMesh(("cpu",) * 4)`` or ``DataMesh(("cuda:0",) * 2)``: every shard
  runs on that one device. It is the port's counterpart of the reference's
  ``--xla_force_host_platform_device_count``, and it is how the sharded
  path runs on the CPU and on a single card.
"""
from __future__ import annotations

import functools
import math

import torch

DATA_AXIS = "data"


class DataMesh:
    """A one-axis (``"data"``) mesh over ``devices``, in shard order.

    Equal and hashable by its devices, so a mesh is a stable cache key.
    """

    __slots__ = ("devices",)
    axis_names = (DATA_AXIS,)

    def __init__(self, devices):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    def __setattr__(self, name, value):
        raise AttributeError("DataMesh is immutable")

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices)}

    def __eq__(self, other):
        return isinstance(other, DataMesh) and other.devices == self.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"


def device_count() -> int:
    """Visible CUDA device count."""
    return torch.cuda.device_count()


@functools.lru_cache(maxsize=None)
def _cached_mesh(devices: tuple) -> DataMesh:
    return DataMesh(devices)


def data_mesh(n_devices: int | None = None) -> DataMesh:
    """A ``("data",)`` mesh over the first ``n_devices`` distinct visible
    CUDA devices (``None``: every one). Cached per device tuple, so
    repeated calls return the *same* object."""
    avail = device_count()
    n = avail if n_devices is None else n_devices
    if not isinstance(n, int) or n < 1:
        raise ValueError(
            f"n_devices must be a positive int, got {n!r} ({avail} CUDA "
            "device(s) visible); for a virtual mesh over one device build "
            "DataMesh(('cuda:0',) * n) or DataMesh(('cpu',) * n)")
    if n > avail:
        raise ValueError(
            f"n_devices={n} but only {avail} CUDA device(s) visible; for a "
            f"virtual mesh over one device build DataMesh(('cuda:0',) * {n})"
            f" or DataMesh(('cpu',) * {n})")
    return _cached_mesh(tuple(torch.device("cuda", i) for i in range(n)))


def mesh_size(mesh) -> int:
    """Total devices in ``mesh`` (1 for ``None``, the no-mesh case)."""
    return 1 if mesh is None else math.prod(mesh.shape.values())
