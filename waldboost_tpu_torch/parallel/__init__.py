"""Batched serving and the device-pool trainer.

- :mod:`.detect` — batched detection over image batches.
- :mod:`.train_step` — one boosting stage over the device-resident pools.
- :mod:`.trainer` — :class:`DevicePool` and :func:`train_sharded`, the
  training loop that keeps the sample pool on the card (BASELINE config
  4b).
"""

from . import detect, train_step, trainer  # noqa: F401
from .train_step import make_train_step  # noqa: F401
from .trainer import DevicePool, train_sharded  # noqa: F401
