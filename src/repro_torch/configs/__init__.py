"""Architecture configurations: a copy of the JAX package's ``configs``
(pure data, no JAX), so the port imports nothing of it."""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, cells_for
