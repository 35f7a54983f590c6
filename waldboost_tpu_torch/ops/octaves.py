"""Kernel S4: the octave chain of a batch, every octave in one launch.

The canvas's first step: octave 0 of each (H, W) frame is the frame,
octave k + 1 the 2x2 average pool of octave k (an odd last row or column
dropped), and every octave of a frame is flattened and concatenated into
one row of the (B, S) octave buffer that the plane builds read
(``ops/planes.py::octave_buffer``).  Each octave is ``ops/image.py::
avg_pool_2`` of the one before: uint8 frames take the uint8 reference's
wrapped arithmetic, float32 frames the float32 chain
(``channels.py::level_octaves``).

:func:`octaves` launches kernel S4 (``csrc/octaves.cu``) on a CUDA tensor:
one launch for the batch up to :data:`LAUNCH_LEVELS` octaves, one more
for each further six.  :func:`octaves_plain`, the plain chain and its
concatenation, serves a CPU tensor.  The two agree byte for byte.  The
JAX package builds its octaves in XLA (``waldboost_tpu/channels.py::
_compute_octaves_f32``), with no Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from .._build import entry, launch, on_card
from ..channels import level_octaves
from .planes import octave_buffer

__all__ = ["LAUNCH_LEVELS", "octave_sizes", "octaves", "octaves_plain"]

#: octaves one launch of S4 writes (``kLevels`` in csrc/octaves.cu): the
#: 64 rows of a block's first octave halve six times
LAUNCH_LEVELS = 7
_DTYPES = (torch.uint8, torch.float32)


def octave_sizes(h: int, w: int, n_octaves: int) -> List[Tuple[int, int]]:
    """``(H_k, W_k)`` of octaves ``k < n_octaves`` of an (h, w) frame:
    each side floor-halved from the previous octave's."""
    return [(h >> k, w >> k) for k in range(n_octaves)]


def _check(images: torch.Tensor, n_octaves: int,
           out: Optional[torch.Tensor]) -> None:
    if not isinstance(images, torch.Tensor) or images.dtype not in _DTYPES \
            or images.dim() != 3:
        raise ValueError("octaves: images must be a (B, H, W) uint8 or "
                         "float32 tensor")
    if not images.is_contiguous():
        raise ValueError("octaves: images must be contiguous")
    if isinstance(n_octaves, bool) or not isinstance(n_octaves, int) \
            or n_octaves < 1:
        raise ValueError(f"octaves: n_octaves must be an int >= 1, not "
                         f"{n_octaves!r}")
    if out is not None:
        B, H, W = images.shape
        shape = (B, sum(h * w for h, w in octave_sizes(H, W, n_octaves)))
        if not isinstance(out, torch.Tensor) or out.dtype != images.dtype \
                or tuple(out.shape) != shape or not out.is_contiguous() \
                or out.device != images.device:
            raise ValueError(f"octaves: out must be a contiguous {shape} "
                             f"{images.dtype} tensor beside the images")


def octaves_plain(images: torch.Tensor, n_octaves: int) -> torch.Tensor:
    """Plain-torch version of :func:`octaves`: the octave chain of the
    frames' dtype, flattened and concatenated."""
    _check(images, n_octaves, None)
    return octave_buffer(level_octaves(images, n_octaves))


_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: in, in_frame, out, out_frame, off, h, w, n_levels, first, batch,
#: is_float, stream
_ARGS = (_VP, _CLL, _VP, _CLL, ctypes.POINTER(_CLL), ctypes.POINTER(_CI),
         ctypes.POINTER(_CI), _CI, _CI, _CI, _CI, _VP)


@functools.lru_cache(maxsize=64)
def _launch_plan(h: int, w: int, n_octaves: int):
    """``(S, launches)`` of (h, w) frames: each launch's first octave (its
    offset in the buffer; 0 for the first launch, which reads the
    frames), its octaves' offsets, heights and widths as C arrays, and how
    many it writes.  Each launch after the first starts from the last
    octave the one before it wrote; none starts from an empty octave."""
    sizes = octave_sizes(h, w, n_octaves)
    offs = [0]
    for oh, ow in sizes:
        offs.append(offs[-1] + oh * ow)
    launches, start = [], 0
    while True:
        stop = min(start + LAUNCH_LEVELS, n_octaves)
        levels = sizes[start:stop]
        if levels[0][0] * levels[0][1] == 0:
            break  # this octave and every later one are empty
        launches.append((offs[start],
                         (_CLL * LAUNCH_LEVELS)(*offs[start:stop]),
                         (_CI * LAUNCH_LEVELS)(*(oh for oh, _ in levels)),
                         (_CI * LAUNCH_LEVELS)(*(ow for _, ow in levels)),
                         len(levels)))
        if stop == n_octaves:
            break
        start = stop - 1
    return offs[-1], tuple(launches)


def octaves(images: torch.Tensor, n_octaves: int,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S) octave buffer of a contiguous (B, H, W) uint8 or float32
    batch: octaves 0 .. ``n_octaves`` - 1 of each frame, flattened and
    concatenated (S their total size), into ``out`` when given (every
    value of it is written).

    Kernel S4 on a CUDA tensor, :func:`octaves_plain` on a CPU tensor;
    ValueError on another dtype, rank or device, on a non-contiguous
    tensor and on an ``out`` of the wrong kind."""
    _check(images, n_octaves, out)
    if not on_card(images, "octaves"):
        res = octaves_plain(images, n_octaves)
        return res if out is None else out.copy_(res)
    B, H, W = images.shape
    S, plan = _launch_plan(H, W, n_octaves)
    dev = images.device
    if out is None:
        out = torch.empty((B, S), dtype=images.dtype, device=dev)
    if B == 0 or not plan:
        return out
    is_float = int(images.dtype == torch.float32)
    base, size = out.data_ptr(), images.element_size()
    fn = entry("octaves", "wb_octaves", _ARGS)
    for start, off, hs, ws, n in plan:
        # the first launch reads the frames, a later one the buffer
        src, frame = (images.data_ptr(), H * W) if start == 0 \
            else (base + start * size, S)
        launch("octaves", fn, dev, src, frame, base, S, off, hs, ws, n,
               int(start > 0), B, is_float)
    return out
