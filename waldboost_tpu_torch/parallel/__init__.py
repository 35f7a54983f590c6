"""Batched serving and the device-pool trainer, on one device or a mesh.

- :mod:`.mesh` — a 1-D mesh of devices over one or several processes.
- :mod:`.detect` — batched detection over image batches.
- :mod:`.train_step` — one boosting stage over the device-resident pools.
- :mod:`.trainer` — :class:`DevicePool` and :func:`train_sharded`, the
  training loop that keeps the sample pool on the card (BASELINE config
  4b).
"""

from . import detect, mesh, train_step, trainer  # noqa: F401
from .mesh import make_mesh, shard_array  # noqa: F401
from .train_step import make_train_step  # noqa: F401
from .trainer import DevicePool, train_sharded  # noqa: F401
