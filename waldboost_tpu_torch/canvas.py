"""The channel-canvas step and the window grid every serving path shares.

:class:`ChannelCanvas` turns a (B, H, W) uint8 batch into the packed
(B, C, Hc, Wc) float32 channel canvas of one packed pyramid plan and one
channel function:

    octaves   uint8 octave chain, flattened      (kernel S4, ops/octaves.py)
    planes    polyphase planes of every level      (kernel B1, ops/planes.py)
    channels  pooled, smoothed channel canvas: grad_hist (C = 4, kernel B2,
              ops/channels.py) or the FPGA integer family and its "+"
              composites (kernel B5, ops/fpga.py)

A (B, H, W) float32 batch takes the f32 octave chain (S4 too), the
float64 plane build (``ops/planes.py::planes_float``, plain torch) and
kernel B2d (``ops/channels.py::grad_hist_float``); the FPGA family runs
its chain on the float planes in plain torch
(``ops/fpga.py::fpga_channels_float``), as the JAX package does in XLA.

At shrink 1, and for channel functions with no polyphase form (grad_mag
and its composites), the canvas is the JAX package's image-space one
(``ops/image_canvas.py``, plain torch as JAX's XLA chain): every level
resized into one image-space canvas with reflected halos, the channel
function over it, then the pool (shrink 2), the smooth and the mask.

A channel function without a canvas form (``cf.canvas`` False: one a
user registers, or a composite with such a part) takes the per-level
canvas (:func:`per_level_canvas`, the JAX package's
``_channel_canvas_per_level``): each level's channels computed on its own
from ``cf.fn`` (``channels.py::level_channels``, plain torch), cast to
float32 and written at the level's place, zero elsewhere.

In fast serving mode (``fast=True``, JAX's ``WB_SERVING_MODE=fast``)
grad_hist takes kernel B2f and the canvas is bfloat16; float32 frames are
served too: f32 octave chain, float planes (``ops/planes.py::
planes_float_fast``, float32 or, with ``fast_float="bf16"``, bfloat16),
then B2f.  The FPGA family has no fast variant: it ignores ``fast``.

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
from typing import Tuple

import numpy as np
import torch

from .channels import (ChannelFunction, _normalize_opts, level_channels,
                       level_octaves)
from .fpga.channels import fpga_kernel_masks
from .ops.channels import grad_hist, grad_hist_fast, grad_hist_float
from .ops.fpga import fpga_channels, fpga_channels_float
from .ops.image_canvas import (ImageCanvasOperands, image_canvas_tables,
                               image_channels, pool_smooth, resize_image)
from .ops.octaves import octaves as octave_buffer_of
from .ops.planes import (FloatPlaneOperands, PlaneOperands,
                         planes, planes_float, planes_float_fast)
from .packing import PackedPyramidPlan
from .polyphase import float_plane_tables, plane_tables
from .profiling import span

#: the plane type of float32 frames in fast serving mode, by ``fast_float``
FAST_FLOAT = {"f32": torch.float32, "bf16": torch.bfloat16}

__all__ = ["ChannelCanvas", "WindowGrid", "channel_canvas", "window_grid",
           "serving_opts", "as_image", "span", "per_level_canvas",
           "is_kernel_canvas"]


def serving_opts(channel_opts: dict, n_channels: int
                 ) -> Tuple[int, int, int, ChannelFunction]:
    """``(shrink, n_per_oct, smooth, cf)`` of channel options; raises when
    the window's channel count is not the function's."""
    shrink, n_per_oct, smooth, cf = _normalize_opts(channel_opts)
    if n_channels != cf.n_channels:
        raise ValueError(f"model window has {n_channels} channels, {cf.name} "
                         f"makes {cf.n_channels}")
    return shrink, n_per_oct, smooth, cf


#: frame types the port serves; float64 frames are rounded to float32, as
#: the JAX package's ``jnp.asarray`` rounds them with 64-bit types off
IMAGE_TYPES = (np.uint8, np.float32)


def as_image(image, ndim: int = 2) -> np.ndarray:
    """A uint8 or float32 numpy image (``ndim`` 2) or batch (``ndim`` 3),
    as the Model API takes them (float64 rounded to float32)."""
    image = np.asarray(image)
    if image.ndim != ndim:
        raise ValueError("Image must have 2 dimensions" if ndim == 2
                         else "images must be (B, H, W)")
    if image.dtype == np.float64:
        image = image.astype(np.float32)
    if image.dtype not in IMAGE_TYPES:
        raise ValueError(f"images must be uint8 or float32 (float64 is "
                         f"rounded to float32), got {image.dtype}")
    return image


def is_image_space(packed: PackedPyramidPlan, cf: ChannelFunction) -> bool:
    """Whether the canvas is built in image space: shrink 1, or a channel
    function with no polyphase form (among those with a canvas form)."""
    return cf.canvas and (packed.shrink == 1 or not cf.poly)


def is_kernel_canvas(packed: PackedPyramidPlan, cf: ChannelFunction) -> bool:
    """Whether the canvas comes from the polyphase kernels (B1 with B2,
    B2d, B2f or B5), not from the image-space or the per-level canvas."""
    return cf.canvas and not is_image_space(packed, cf)


def per_level_canvas(images: torch.Tensor, packed: PackedPyramidPlan,
                     smooth: int, cf: ChannelFunction) -> torch.Tensor:
    """(B, C, Hc, Wc) float32 canvas of a (B, H, W) batch of any frame
    type: each level of ``packed`` computed on its own
    (:func:`~.channels.level_channels` of the octave chain), cast to
    float32 and written at its ``(y, x)``; zero elsewhere."""
    B = images.shape[0]
    canvas = torch.zeros((B, cf.n_channels, packed.canvas_h, packed.canvas_w),
                         dtype=torch.float32, device=images.device)
    if not packed.levels:
        return canvas
    octaves = level_octaves(images, max(pl.level.octave
                                        for pl in packed.levels) + 1)
    for pl in packed.levels:
        lv = pl.level
        canvas[:, :, pl.y:pl.y + lv.out_height, pl.x:pl.x + lv.out_width] = \
            level_channels(octaves[lv.octave], lv, packed.shrink, smooth, cf)
    return canvas


class ChannelCanvas:
    """octaves -> planes (B1) -> channel canvas (B2 for grad_hist, B5 for
    the FPGA family) of one packed plan and channel function ``cf`` for
    ``image_shape`` frames on one device; float32 frames take the float
    plane build and B2d.  With ``fast``, B2f, and the float frames' planes
    of type ``fast_float`` (``"f32"`` or ``"bf16"``).  The plane tables of
    each frame type are built at its first batch.

    ``image_space`` (shrink 1, or a function with no polyphase form):
    octaves -> the image-space canvas (:meth:`planes`) -> channels, pool,
    smooth (:meth:`channels`), plain torch; with ``fast`` the exact canvas
    rounded to bfloat16, as the JAX package's batched detector walks it
    when it does not count n_weak (``parallel/detect.py::
    serving_canvas``).

    ``per_level`` (a function without a canvas form): :func:`per_level_canvas`
    in one call (:meth:`__call__` only), bfloat16 with ``fast`` as the
    image-space canvas is."""

    def __init__(self, packed: PackedPyramidPlan, image_shape: Tuple[int, int],
                 smooth: int, cf: ChannelFunction, device: torch.device,
                 fast: bool = False, fast_float: str = "f32"):
        if fast_float not in FAST_FLOAT:
            raise ValueError(f"fast_float must be one of {sorted(FAST_FLOAT)}"
                             f", got {fast_float!r}")
        self.packed = packed
        self.image_shape = tuple(image_shape)
        self.smooth = smooth
        self.cf = cf
        self.device = device
        self.fast = bool(fast) and cf.fused_kind is None
        self.fast_float = fast_float
        # the packer's (even) reflect halo is baked into the plane taps of
        # reflect-boundary functions; the FPGA family reads zeros instead
        halo = packed.halo if cf.boundary == "reflect" and cf.halo > 0 else 0
        self.halo = halo
        self.n_octaves = max((pl.level.octave for pl in packed.levels),
                             default=-1) + 1
        self.image_space = is_image_space(packed, cf)
        self.per_level = not cf.canvas
        if self.per_level:
            ring = interior = None
        elif self.image_space:
            # image-space masks: the stencil border (FPGA kinds) and the
            # smooth interior, bool
            ring = packed.stencil_border_mask() \
                if cf.boundary == "stencil_zero" else None
            interior = packed.smooth_interior_mask() if smooth == 1 else None
        elif cf.fused_kind is not None:
            ring, interior = fpga_kernel_masks(packed, smooth)
        else:
            ring = None
            interior = packed.smooth_interior_mask().astype(np.uint8) \
                if smooth == 1 else None
        self.ring, self.interior = (
            None if a is None else torch.as_tensor(a, device=device)
            for a in (ring, interior))

    @functools.cached_property
    def plane_ops(self) -> PlaneOperands:
        """B1's tables (built at the first uint8 batch)."""
        return PlaneOperands.build(
            plane_tables(self.packed, self.halo, self.image_shape),
            self.device)

    @functools.cached_property
    def float_plane_ops(self) -> FloatPlaneOperands:
        """The float plane tables (built at the first float batch)."""
        return FloatPlaneOperands.build(
            float_plane_tables(self.packed, self.halo, self.image_shape),
            self.device)

    @functools.cached_property
    def image_tables(self):
        """The image-space canvas's host tables (at the first batch)."""
        return image_canvas_tables(self.packed, self.halo, self.image_shape)

    @functools.cached_property
    def image_ops(self) -> ImageCanvasOperands:
        """The image-space resize of uint8 frames on the device."""
        return ImageCanvasOperands.build(self.image_tables, self.device, True)

    @functools.cached_property
    def image_float_ops(self) -> ImageCanvasOperands:
        """The image-space resize of float frames on the device."""
        return ImageCanvasOperands.build(self.image_tables, self.device,
                                         False)

    @functools.cached_property
    def rmap(self):
        """The halo reflection of intermediate channels (grad_mag) as a
        device index, built once per canvas step."""
        rmap = self.image_tables.rmap
        return None if rmap is None else torch.as_tensor(
            rmap.astype(np.int32), device=self.device)

    def octaves(self, images: torch.Tensor) -> torch.Tensor:
        """The (B, S) octave buffer of the batch (S4 on the card)."""
        return octave_buffer_of(images.contiguous(), self.n_octaves)

    def planes(self, octs: torch.Tensor) -> torch.Tensor:
        """The polyphase planes, or on the image-space path the (B, H, W)
        float32 image canvas."""
        if self.image_space:
            return resize_image(octs, self.image_float_ops
                                if octs.is_floating_point()
                                else self.image_ops)
        if not octs.is_floating_point():
            return planes(octs, self.plane_ops)
        if self.fast:
            return planes_float_fast(octs, self.float_plane_ops,
                                     FAST_FLOAT[self.fast_float])
        return planes_float(octs, self.float_plane_ops)

    def channels(self, plane_canvas: torch.Tensor) -> torch.Tensor:
        if self.image_space:
            chns = image_channels(plane_canvas, self.cf, self.rmap,
                                  self.ring)
            chns = pool_smooth(chns, self.packed.shrink, self.smooth,
                               self.interior, self.cf.fused_kind is not None)
            return chns.to(torch.bfloat16) if self.fast else chns
        if self.cf.fused_kind is not None:
            fn = fpga_channels_float if plane_canvas.is_floating_point() \
                else fpga_channels
            return fn(plane_canvas, self.ring, self.interior,
                      self.cf.fused_kind, self.smooth)
        if self.fast:
            return grad_hist_fast(plane_canvas, self.interior, self.smooth)
        if plane_canvas.is_floating_point():
            return grad_hist_float(plane_canvas, self.interior, self.smooth)
        return grad_hist(plane_canvas, self.interior, self.smooth)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(B, C, Hc, Wc) canvas of a (B, H, W) uint8 or float32 batch:
        float32, bfloat16 in fast mode (grad_hist)."""
        if self.per_level:
            with span("wb.channels"):
                chns = per_level_canvas(images, self.packed, self.smooth,
                                        self.cf)
            return chns.to(torch.bfloat16) if self.fast else chns
        with span("wb.octaves"):
            octs = self.octaves(images)
        with span("wb.planes"):
            plane_canvas = self.planes(octs)
        with span("wb.channels"):
            return self.channels(plane_canvas)


def channel_canvas(packed: PackedPyramidPlan, image_shape: Tuple[int, int],
                   smooth: int, cf: ChannelFunction, device: torch.device,
                   fast: bool = False,
                   fast_float: str = "f32") -> ChannelCanvas:
    """The cached :class:`ChannelCanvas` of these arguments (the FPGA
    family's exact and fast canvases are one)."""
    return _channel_canvas(packed, tuple(image_shape), smooth, cf, device,
                           bool(fast) and cf.fused_kind is None, fast_float)


@functools.lru_cache(maxsize=32)
def _channel_canvas(packed, image_shape, smooth, cf, device, fast,
                    fast_float) -> ChannelCanvas:
    return ChannelCanvas(packed, image_shape, smooth, cf, device, fast,
                         fast_float)


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
