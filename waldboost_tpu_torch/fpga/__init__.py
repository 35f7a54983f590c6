"""FPGA integer channel family: uint8-in, uint8-valued gradient features.

Counterpart of ``waldboost_tpu/fpga/`` for serving: the two channel
functions and their ``"+"`` composites, computed by kernel B5
(``ops/fpga.py``).  The bank-restricted quantized trainer is not ported
(ROADMAP item A9).
"""

from .channels import grad_hist_4_u1, grad_mag_u1  # noqa: F401
