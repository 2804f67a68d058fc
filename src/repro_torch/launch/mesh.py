"""Production meshes as device-free shapes (``sharding.rules.MeshShape``):
the JAX package's 16 x 16 and 2 x 16 x 16 meshes, which the dry-run's
account splits its cells over.  No device is touched.

``NODE_SIZE`` is the GPUs of one HGX H100 node: a collective whose group
spans nodes crosses InfiniBand, one inside a node NVLink (the role of the
reference analysis's pod boundary).
"""
from __future__ import annotations

from repro_torch.sharding.rules import MeshShape

NODE_SIZE = 8


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 devices over ("data", "model"); multi_pod adds a
    leading "pod" axis of 2."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_debug_mesh(devices: int = 8, model: int = 2) -> MeshShape:
    """A small (devices // model, model) mesh over ("data", "model")."""
    if devices % model:
        raise ValueError(f"{devices} devices do not split into a model axis "
                         f"of {model}")
    return MeshShape(("data", "model"), (devices // model, model))
