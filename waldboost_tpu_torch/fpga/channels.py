"""FPGA integer channel functions and the masks kernel B5 takes.

Counterpart of ``waldboost_tpu/fpga/channels.py``: ``grad_hist_4_u1`` (4
fixed-orientation Sobel responses) and ``grad_mag_u1`` (``max(|dx|,
|dy|)``), each ``min(|r| >> 2, 255)``, with zero stencil borders around
every level (``boundary="stencil_zero"``, no reflect halo).  Registered
under the JAX package's names and aliases, the reference's
``waldboost.fpga.channels.*`` and ``waldboost.fpga.nb_channels.*`` too.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..channels import ChannelFunction, register_channel_function
from ..ops.image_canvas import fpga_responses, sobel
from ..packing import PackedPyramidPlan

__all__ = ["grad_hist_4_u1", "grad_mag_u1", "fpga_kernel_masks"]


def _fpga_fn(kind: str, image: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) uint8 channels of an FPGA ``kind`` of (..., H, W)
    images: the int32 Sobel with zero borders, ``min(|r| // 4, 255)``
    (``waldboost_tpu/fpga/channels.py::_grad_hist_4_u1_fn``,
    ``_grad_mag_u1_fn``)."""
    return fpga_responses(kind, *sobel(image)).to(torch.uint8)


grad_hist_4_u1 = register_channel_function(ChannelFunction(
    name="waldboost_tpu.fpga.channels.grad_hist_4_u1",
    fn=functools.partial(_fpga_fn, "grad_hist_4_u1"),
    n_channels=4,
    aliases=("grad_hist_4_u1", "waldboost.fpga.channels.grad_hist_4_u1",
             "waldboost.fpga.nb_channels.grad_hist_4_u1"),
    halo=0,
    boundary="stencil_zero",
    fused_kind="grad_hist_4_u1",
    canvas=True,
))

grad_mag_u1 = register_channel_function(ChannelFunction(
    name="waldboost_tpu.fpga.channels.grad_mag_u1",
    fn=functools.partial(_fpga_fn, "grad_mag_u1"),
    n_channels=1,
    aliases=("grad_mag_u1", "waldboost.fpga.channels.grad_mag_u1",
             "waldboost.fpga.nb_channels.grad_mag_u1"),
    halo=0,
    boundary="stencil_zero",
    fused_kind="grad_mag_u1",
    canvas=True,
))


def fpga_kernel_masks(packed: PackedPyramidPlan, smooth: int
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``(ring, interior)`` uint8 masks of one packed plan: the (2, 2, Hc,
    Wc) polyphase stencil ring mask ``ring[a, b, i, j] =
    border[2i + a, 2j + b]`` of :meth:`PackedPyramidPlan.
    stencil_border_mask`, and with ``smooth == 1`` the (Hc, Wc) smooth
    interior mask (None otherwise).  Not cached here: the serving paths
    build them once per plan through the cached canvas step."""
    bm = packed.stencil_border_mask()
    h2, w2 = bm.shape
    ring = np.ascontiguousarray(bm.reshape(h2 // 2, 2, w2 // 2, 2)
                                .transpose(1, 3, 0, 2).astype(np.uint8))
    interior = packed.smooth_interior_mask().astype(np.uint8) \
        if smooth == 1 else None
    return ring, interior
