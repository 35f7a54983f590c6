"""The channel-canvas step and the window grid every serving path shares.

:class:`ChannelCanvas` turns a (B, H, W) uint8 batch into the packed
(B, C, Hc, Wc) float32 channel canvas of one packed pyramid plan and one
channel function:

    octaves   uint8 octave chain, flattened (channels.py, integer torch)
    planes    polyphase planes of every level      (kernel B1, ops/planes.py)
    channels  pooled, smoothed channel canvas: grad_hist (C = 4, kernel B2,
              ops/channels.py) or the FPGA integer family and its "+"
              composites (kernel B5, ops/fpga.py)

:class:`WindowGrid` holds one window shape's view of that canvas: the valid
mask of window origins and the level maps that turn an origin into an
image-space box.  Both are built once per (plan, frame size or window,
channel function, device) and cached, so ``Model``,
``make_batched_detector``, ``make_batched_detector_boxes`` and the
multi-model paths share them.

While a torch profiler runs, each step runs inside a ``record_function``
span named ``wb.<step>``, so a trace attributes host and device time to
the layers.
"""

from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .channels import ChannelFunction, _normalize_opts, octave_chain
from .channels import grad_hist as grad_hist_cf  # the ops module's name
from .fpga.channels import fpga_kernel_masks
from .ops.channels import grad_hist
from .ops.fpga import fpga_channels
from .ops.planes import PlaneOperands, octave_buffer, planes
from .packing import PackedPyramidPlan
from .polyphase import plane_tables

__all__ = ["ChannelCanvas", "WindowGrid", "channel_canvas", "window_grid",
           "serving_opts", "as_image", "span"]


def span(name: str):
    """A profiler span while a torch profiler runs, else nothing: an
    ungated ``record_function`` costs about 10 us of host time per span."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return nullcontext()


def serving_opts(channel_opts: dict, n_channels: int
                 ) -> Tuple[int, int, int, ChannelFunction]:
    """``(shrink, n_per_oct, smooth, cf)`` of channel options the port
    serves; raises on the options it does not serve yet."""
    shrink, n_per_oct, smooth, cf = _normalize_opts(channel_opts)
    if shrink != 2:
        raise NotImplementedError("only the shrink=2 polyphase pipeline is "
                                  "ported (ROADMAP item A2)")
    if cf.fused_kind is None and cf != grad_hist_cf:
        raise NotImplementedError(f"the canvas of {cf.name} is not ported "
                                  "yet (ROADMAP item A14)")
    if n_channels != cf.n_channels:
        raise ValueError(f"model window has {n_channels} channels, {cf.name} "
                         f"makes {cf.n_channels}")
    return shrink, n_per_oct, smooth, cf


def as_image(image, ndim: int = 2) -> np.ndarray:
    """A uint8 numpy image (``ndim`` 2) or batch (``ndim`` 3), as the Model
    API takes them."""
    image = np.asarray(image)
    if image.ndim != ndim:
        raise ValueError("Image must have 2 dimensions" if ndim == 2
                         else "images must be (B, H, W)")
    if image.dtype != np.uint8:
        raise NotImplementedError("only uint8 images are ported; float "
                                  "images are ROADMAP item A6")
    return image


class ChannelCanvas:
    """octaves -> planes (B1) -> channel canvas (B2 for grad_hist, B5 for
    the FPGA family) of one packed plan and channel function ``cf`` for
    ``image_shape`` frames on one device."""

    def __init__(self, packed: PackedPyramidPlan, image_shape: Tuple[int, int],
                 smooth: int, cf: ChannelFunction, device: torch.device):
        self.packed = packed
        self.image_shape = tuple(image_shape)
        self.smooth = smooth
        self.cf = cf
        self.device = device
        # the packer's (even) reflect halo is baked into the plane taps of
        # reflect-boundary functions; the FPGA family reads zeros instead
        halo = packed.halo if cf.boundary == "reflect" and cf.halo > 0 else 0
        tables = plane_tables(packed, halo, self.image_shape)
        self.plane_ops = PlaneOperands.build(tables, device)
        self.n_octaves = len(tables.oct_hw)
        if cf.fused_kind is not None:
            ring, interior = fpga_kernel_masks(packed, smooth)
        else:
            ring = None
            interior = packed.smooth_interior_mask().astype(np.uint8) \
                if smooth == 1 else None
        self.ring, self.interior = (
            None if a is None else torch.as_tensor(a, device=device)
            for a in (ring, interior))

    def octaves(self, images: torch.Tensor) -> torch.Tensor:
        return octave_buffer(octave_chain(images, self.n_octaves))

    def planes(self, octs: torch.Tensor) -> torch.Tensor:
        return planes(octs, self.plane_ops)

    def channels(self, plane_canvas: torch.Tensor) -> torch.Tensor:
        if self.cf.fused_kind is not None:
            return fpga_channels(plane_canvas, self.ring, self.interior,
                                 self.cf.fused_kind, self.smooth)
        return grad_hist(plane_canvas, self.interior, self.smooth)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(B, C, Hc, Wc) float32 canvas of a (B, H, W) uint8 batch."""
        with span("wb.octaves"):
            octs = self.octaves(images)
        with span("wb.planes"):
            plane_canvas = self.planes(octs)
        with span("wb.channels"):
            return self.channels(plane_canvas)


@functools.lru_cache(maxsize=32)
def channel_canvas(packed: PackedPyramidPlan, image_shape: Tuple[int, int],
                   smooth: int, cf: ChannelFunction,
                   device: torch.device) -> ChannelCanvas:
    return ChannelCanvas(packed, image_shape, smooth, cf, device)


class WindowGrid:
    """One window shape's origin grid over a packed canvas on a device:
    ``valid`` (GU, GV) uint8 mask, ``level_id`` (GU, GV) int64 (-1 outside
    levels), ``offsets`` (L, 2) int64 level (y, x) and ``inv_scales`` (L,)
    float32, with their numpy sources; ``n_loc`` counts the origins inside
    levels (the eval-cost denominator)."""

    def __init__(self, packed: PackedPyramidPlan, window: Tuple[int, int],
                 device: torch.device):
        self.window = tuple(window)
        self.level_id_np, self.inv_scales_np = packed.level_maps(self.window)
        self.offsets_np = np.array([(pl.y, pl.x) for pl in packed.levels],
                                   np.int64).reshape(-1, 2)
        self.n_loc = int((self.level_id_np >= 0).sum())
        self.valid = torch.as_tensor(
            packed.valid_mask(self.window).astype(np.uint8), device=device)
        self.level_id = torch.as_tensor(self.level_id_np.astype(np.int64),
                                        device=device)
        self.offsets = torch.as_tensor(self.offsets_np, device=device)
        self.inv_scales = torch.as_tensor(self.inv_scales_np, device=device)


@functools.lru_cache(maxsize=32)
def window_grid(packed: PackedPyramidPlan, window: Tuple[int, int],
                device: torch.device) -> WindowGrid:
    return WindowGrid(packed, window, device)
