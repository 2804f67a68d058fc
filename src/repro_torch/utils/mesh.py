"""A one-axis device mesh: the counterpart of what the JAX package uses
from ``jax.make_mesh`` / ``jax.sharding.Mesh`` for its row-sharded scans.

The JAX mesh has one controller: one Python process owns the index and
its ``shard_map`` runs the local stage on each of that process's devices.
The port keeps that design.  A ``Mesh`` lists the ``torch.device`` of
each shard in shard order; ``core.search`` launches each shard's local
scan on its device and copies the candidates to the index's device for
the merge.  A device may hold several shards (the counterpart of
``--xla_force_host_platform_device_count``): on one card, or on the CPU
in the tests, the shards are co-located.
"""
from __future__ import annotations

import torch

from repro_torch.utils.device import resolve_device


class Mesh:
    """Devices in shard order along one named axis.  ``shape[axis]`` is
    the shard count; two meshes with the same devices and axis name are
    equal (and hash equal), so either keys the same cached layout."""

    def __init__(self, devices, axis_names):
        axis_names = ((axis_names,) if isinstance(axis_names, str)
                      else tuple(axis_names))
        if len(axis_names) != 1:
            raise ValueError(f"the port's mesh has one axis, got "
                             f"{axis_names!r}")
        devices = tuple(resolve_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = {axis_names[0]: len(devices)}

    def _key(self):
        return self.devices, self.axis_names

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names!r})")


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A one-axis mesh of ``shape`` (an int or a 1-tuple) shards.

    devices=None takes the first shape visible CUDA cards and raises when
    fewer exist (it never falls back to the CPU).  An explicit list gives
    each shard's device and may repeat one, e.g. ``["cpu"] * 4`` or
    ``["cuda:0"] * 2`` for co-located shards.
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if len(shape) != 1 or shape[0] < 1:
        raise ValueError(f"the port's mesh has one axis of >= 1 shards, "
                         f"got shape {shape}")
    if devices is None:
        resolve_device("cuda")
        have = torch.cuda.device_count()
        if have < shape[0]:
            raise RuntimeError(f"mesh of {shape[0]} shards needs {shape[0]} "
                               f"CUDA devices, {have} visible; pass devices= "
                               f"to co-locate shards")
        devices = [torch.device("cuda", i) for i in range(shape[0])]
    devices = list(devices)
    if len(devices) != shape[0]:
        raise ValueError(f"mesh shape {shape} needs {shape[0]} devices, got "
                         f"{len(devices)}")
    return Mesh(devices, axis_names)


def shard_count(mesh, axis: str) -> int:
    """The number of shards of ``mesh`` along ``axis``; raises TypeError
    for anything that is not a ``Mesh`` and ValueError for an unknown
    axis."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.utils.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes "
                         f"{mesh.axis_names})")
    return mesh.shape[axis]
