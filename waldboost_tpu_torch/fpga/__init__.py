"""FPGA integer channel family and its bank-restricted quantized trainer.

Counterpart of ``waldboost_tpu/fpga/``: the two channel functions and
their ``"+"`` composites, computed by kernel B5 (``ops/fpga.py``), the
pixel banks, and :func:`train`.
"""

from .banks import BankScheduler, PixelBanks  # noqa: F401
from .channels import grad_hist_4_u1, grad_mag_u1  # noqa: F401


def __getattr__(name):
    # the trainer imports the sample pool, which imports the model, which
    # imports this package's channels: load it at first use
    if name in ("DTree", "train"):
        from . import training
        return getattr(training, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
