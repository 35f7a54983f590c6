"""Channel functions, the static pyramid plan, the octave chains and the
per-level channel pyramid.

Counterpart of ``waldboost_tpu/channels.py``.  The pyramid plan is the same
host arithmetic (level sizes snapped with ``int((w*s)/shrink)*shrink``), and
the registry holds the built-in channel functions (``grad_hist`` and
``grad_mag`` here, the FPGA integer family in ``fpga/channels.py``,
imported at the first lookup that misses), ``"a+b"`` composites, and any
function a user registers.  The octave chain (:func:`level_octaves`;
uint8 frames: integer, float32 frames: f32) is plain torch on the
caller's device.

:func:`compute_pyramid` gives every level's channels: cut out of the
packed kernel canvas for functions with a canvas form, else level by
level as the JAX package's ``_level_channels`` computes them (the octave
chain, ``resize_bilinear`` back to the frame's dtype, the function in its
own output dtype, ``avg_pool_2`` at shrink 2, ``smooth_3x3``; plain torch,
``ops/image.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .ops import image as imops
from .ops.channels import project_bins

__all__ = ["ChannelFunction", "Level", "grad_hist", "grad_mag",
           "default_channel_opts", "pyramid_plan",
           "register_channel_function", "resolve_channel_function",
           "compose_channel_functions", "level_octaves", "level_channels",
           "compute_pyramid", "channel_pyramid"]


@dataclasses.dataclass(frozen=True)
class ChannelFunction:
    """A named image -> channels transform.

    ``fn`` maps an (H, W) image (in the dtype the resize keeps: the
    frame's) to a (C, H, W) channel tensor; calling the function calls it.
    ``name`` is the canonical registry key, written into saved models, and
    ``aliases`` further accepted names.  The fields the port reads beside
    it: the channel count, the image-space halo its stencils read around
    each level, how a level's edge is read (``boundary``: ``"reflect"``
    halos or the FPGA family's ``"stencil_zero"`` ring), the FPGA response
    kind (``fused_kind``, kernel B5's ``kind``; None for the float
    family), whether it has a polyphase form (``poly``: the shrink-2
    pipeline of kernels B1 and B2 or B5; without one every shrink takes
    the image-space canvas), a composite's canonical part names
    (``parts``, empty for a single function), and ``canvas``: whether the
    port builds the whole packed channel canvas in one pass (the built-in
    functions and composites of them only; JAX: ``canvas_fn is not
    None``).  A function without a canvas form, such as one a user
    registers, is computed level by level from ``fn``
    (:func:`compute_pyramid`)."""

    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    n_channels: int
    aliases: Tuple[str, ...] = ()
    halo: int = 1
    boundary: str = "reflect"
    fused_kind: Optional[str] = None
    poly: bool = True
    parts: Tuple[str, ...] = ()
    canvas: bool = False

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        return self.fn(image)

    def leaves(self) -> Tuple[str, ...]:
        """The canonical names of the single functions, in channel order."""
        return self.parts or (self.name,)


_REGISTRY: Dict[str, ChannelFunction] = {}


def register_channel_function(cf: ChannelFunction) -> ChannelFunction:
    for key in (cf.name,) + tuple(cf.aliases):
        _REGISTRY[key] = cf
    return cf


def _grad_hist_fn(image: torch.Tensor) -> torch.Tensor:
    """grad_hist's 4 oriented-gradient projections of an (..., H, W)
    image: uint8 images take the float32 prefilter (exact on integers),
    other types the once-rounded float64 one; each bin ``abs(f32(f64(gx)
    * cos - f64(gy) * sin))`` (``waldboost_tpu/channels.py::
    _grad_hist_fn``)."""
    exact = image.dtype == torch.uint8
    return project_bins(*imops.gradients(image, float_dd=not exact))


def _grad_mag_fn(image: torch.Tensor, norm: int = 5,
                 eps: float = 1e-3) -> torch.Tensor:
    """grad_mag's locally normalised gradient magnitude of an (..., H, W)
    image, 1 channel: float32 gradients, ``sqrt(gx*gx + gy*gy)`` correctly
    rounded, over its triangle filter (float32 taps, symmetric-reflect
    edges) plus ``eps`` (``waldboost_tpu/channels.py::_grad_mag_fn``)."""
    gx, gy = imops.gradients(image)
    mag = torch.sqrt((gx * gx + gy * gy).double()).to(torch.float32)
    nrm = imops.separable_filter_reflect(mag, imops.triangle_kernel(norm))
    return (mag / (nrm + eps)).unsqueeze(-3)


grad_hist = register_channel_function(ChannelFunction(
    name="waldboost_tpu.channels.grad_hist",
    fn=_grad_hist_fn,
    n_channels=4,
    aliases=("grad_hist", "waldboost.channels.grad_hist",
             "waldboost.nb_channels.grad_hist"),
    halo=1,
    canvas=True,
))

#: the locally normalised gradient magnitude: gradients, ``sqrt(gx*gx +
#: gy*gy)``, divided by its triangle-filtered self plus 1e-3; the halo is
#: the gradient's radius 1 plus the triangle's 5.  No polyphase form: it
#: takes the image-space canvas at every shrink.
grad_mag = register_channel_function(ChannelFunction(
    name="waldboost_tpu.channels.grad_mag",
    fn=_grad_mag_fn,
    n_channels=1,
    aliases=("grad_mag", "waldboost.channels.grad_mag",
             "waldboost.nb_channels.grad_mag"),
    halo=6,
    poly=False,
    canvas=True,
))

#: the reference's default channel options
default_channel_opts = dict(shrink=2, n_per_oct=8, smooth=1,
                            channels=grad_hist)


def resolve_channel_function(name_or_cf) -> ChannelFunction:
    """Registry lookup by name, as the JAX package resolves it.  Objects
    with a ``name`` attribute (such as the JAX package's channel functions)
    resolve by that name; ``"a+b"`` names resolve to
    :func:`compose_channel_functions`."""
    if isinstance(name_or_cf, ChannelFunction):
        return name_or_cf
    name = getattr(name_or_cf, "name", name_or_cf)
    if name not in _REGISTRY:
        # the FPGA family registers on import; pull it in lazily so a saved
        # model loads without the caller importing it
        importlib.import_module(__package__ + ".fpga.channels")
    if name in _REGISTRY:
        return _REGISTRY[name]
    if isinstance(name, str) and "+" in name:
        return compose_channel_functions(*name.split("+"))
    raise KeyError(f"Unknown channel function {name!r}. Registered: "
                   f"{sorted(set(cf.name for cf in _REGISTRY.values()))}")


def compose_channel_functions(*parts) -> ChannelFunction:
    """Channel functions stacked along the channel axis in argument order,
    registered under ``"+".join`` of the parts' canonical names (the name
    the JAX package writes into model files) with the given spelling as an
    alias.  ``fn`` concatenates the parts' ``fn`` along the channel axis
    (dtypes promoted as ``torch.cat`` does: uint8 with float32 gives
    float32).  FPGA parts compose into one B5 kind; the composite has a
    canvas form only when every part has one."""
    cfs = [resolve_channel_function(p) for p in parts]
    if len(cfs) < 2:
        raise ValueError("a composite needs at least two channel functions")
    name = "+".join(cf.name for cf in cfs)
    if name in _REGISTRY:
        return _REGISTRY[name]
    if any(cf.boundary != cfs[0].boundary for cf in cfs):
        raise ValueError("composed channel functions must share a boundary "
                         "convention")
    fused = None
    if all(cf.fused_kind is not None for cf in cfs):
        fused = "+".join(cf.fused_kind for cf in cfs)

    def fn(image):
        return torch.cat([cf.fn(image) for cf in cfs], dim=-3)

    return register_channel_function(ChannelFunction(
        name=name,
        fn=fn,
        n_channels=sum(cf.n_channels for cf in cfs),
        aliases=("+".join(getattr(p, "name", p) for p in parts),),
        halo=max(cf.halo for cf in cfs),
        boundary=cfs[0].boundary,
        fused_kind=fused,
        poly=all(cf.poly for cf in cfs),
        parts=sum((cf.leaves() for cf in cfs), ()),
        canvas=all(cf.canvas for cf in cfs),
    ))


@dataclasses.dataclass(frozen=True)
class Level:
    octave: int      # which halved octave image this level resizes from
    height: int      # resize target of the octave image (pre-shrink)
    width: int
    out_height: int  # channel tensor size after optional shrink pooling
    out_width: int
    scale: float     # channel-grid coordinate * 1/scale = image coordinate


def _normalize_opts(channel_opts: dict) -> Tuple[int, int, int,
                                                 ChannelFunction]:
    shrink = int(channel_opts["shrink"])
    n_per_oct = int(channel_opts["n_per_oct"])
    smooth = int(channel_opts["smooth"])
    cf = resolve_channel_function(channel_opts["channels"])
    if shrink not in (1, 2):
        raise ValueError("Shrink factor must be integer 1 <= shrink <= 2")
    return shrink, n_per_oct, smooth, cf


@functools.lru_cache(maxsize=None)
def pyramid_plan(h: int, w: int, shrink: int,
                 n_per_oct: int) -> Tuple[Level, ...]:
    """Every pyramid level of an (h, w) image: octave halving while the
    octave's sides are >= 8, ``n_per_oct`` scales per octave."""
    levels: List[Level] = []
    oh, ow = h, w
    octave = 0
    factor = 2.0 ** (-1.0 / n_per_oct)
    while oh >= 8 and ow >= 8:
        for i in range(n_per_oct):
            s = factor ** i
            nw = int((ow * s) / shrink) * shrink
            nh = int((oh * s) / shrink) * shrink
            real_scale = nw / w
            levels.append(Level(octave=octave, height=nh, width=nw,
                                out_height=nh // shrink,
                                out_width=nw // shrink,
                                scale=real_scale / shrink))
        oh, ow = oh // 2, ow // 2
        octave += 1
    return tuple(levels)


def level_octaves(images: torch.Tensor, n_octaves: int
                  ) -> List[torch.Tensor]:
    """The octave images of (..., H, W) images of any dtype: each the
    previous one's :func:`~.ops.image.avg_pool_2`, an odd last row or
    column dropped.  uint8 takes the uint8 reference's arithmetic (the
    row pair sum wraps mod 256, then the column pair sum, then
    ``floor(/4)``), float32 ``(((tl + bl) + tr) + br) / 4`` in f32
    (``waldboost_tpu/ops/image.py::avg_pool_2``): the plain chain of
    kernel S4 (``ops/octaves.py``)."""
    octaves = [images]
    for _ in range(n_octaves - 1):
        octaves.append(imops.avg_pool_2(octaves[-1]))
    return octaves


def level_channels(oct_images: torch.Tensor, level: Level, shrink: int,
                   smooth: int, cf: ChannelFunction) -> torch.Tensor:
    """(..., C, out_height, out_width) channels of one level from its
    (..., h, w) octave images: resized back to their dtype, ``cf`` on
    each (H, W) image in its own output dtype, the 2x2 average pool at
    shrink 2 and the 3x3 smooth (``waldboost_tpu/channels.py::
    _level_channels``)."""
    im = imops.resize_bilinear(oct_images, level.height, level.width)
    flat = im.reshape((-1,) + tuple(im.shape[-2:]))
    chns = torch.stack([cf(x) for x in flat])
    want = (flat.shape[0], cf.n_channels, level.height, level.width)
    if tuple(chns.shape) != want:
        raise ValueError(f"channel function {cf.name!r} gave "
                         f"{tuple(chns.shape[1:])} for a {tuple(want[2:])} "
                         f"image, not {want[1:]}")
    chns = chns.reshape(im.shape[:-2] + chns.shape[1:])
    if shrink == 2:
        chns = imops.avg_pool_2(chns)
    if smooth == 1:
        chns = imops.smooth_3x3(chns)
    return chns


def _as_frame(image, device) -> torch.Tensor:
    """An (H, W) uint8 or float32 frame on ``device`` from a numpy array
    or tensor (float64 rounded to float32; other types raise, as the
    Model API's frames)."""
    from .canvas import as_image
    if isinstance(image, torch.Tensor):
        if image.dim() != 2:
            raise ValueError("Image must have 2 dimensions")
        t = image.to(torch.float32) if image.dtype == torch.float64 \
            else image
        if t.dtype not in (torch.uint8, torch.float32):
            raise ValueError(f"images must be uint8 or float32 (float64 is "
                             f"rounded to float32), got {image.dtype}")
    else:
        t = torch.from_numpy(np.ascontiguousarray(as_image(image)))
    return t.to(device)


def compute_pyramid(image, channel_opts: dict, device=None
                    ) -> List[Tuple[torch.Tensor, float]]:
    """``(chns, scale)`` of every level of :func:`pyramid_plan`, in plan
    order, ``chns`` a (C, out_height, out_width) tensor on ``device`` (the
    card when None).

    ``image`` is an (H, W) uint8 or float32 numpy array or tensor (float64
    is rounded to float32).  A function with a canvas form has its levels
    cut out of the packed channel canvas of every level (kernels B1 and
    B2, B2d or B5, or the image-space canvas): float32, the FPGA family's
    uint8.  Any other function goes level by level
    (:func:`level_channels`), in ``fn``'s own output dtype."""
    from .canvas import channel_canvas
    from .device import resolve_device
    from .packing import _packed_plan_cached

    shrink, n_per_oct, smooth, cf = _normalize_opts(channel_opts)
    dev = resolve_device(device)
    frame = _as_frame(image, dev)
    h, w = frame.shape
    plan = pyramid_plan(h, w, shrink, n_per_oct)
    if not plan:
        return []
    if cf.canvas:
        packed = _packed_plan_cached(h, w, shrink, n_per_oct, (0, 0),
                                     halo=cf.halo)
        canvas = channel_canvas(packed, (h, w), smooth, cf, dev)(
            frame[None])[0]
        if cf.fused_kind is not None:
            canvas = canvas.to(torch.uint8)
        cut = {pl.plan_index: canvas[:, pl.y:pl.y + pl.level.out_height,
                                     pl.x:pl.x + pl.level.out_width]
               for pl in packed.levels}
        return [(cut[i], lv.scale) for i, lv in enumerate(plan)]
    octaves = level_octaves(frame, plan[-1].octave + 1)
    return [(level_channels(octaves[lv.octave], lv, shrink, smooth, cf),
             lv.scale) for lv in plan]


def channel_pyramid(image, channel_opts: dict, device=None
                    ) -> Iterator[Tuple[np.ndarray, float]]:
    """``(chns, scale)`` for each level of :func:`pyramid_plan`, in plan
    order: the level's (out_height, out_width, C) channels as numpy, from
    :func:`compute_pyramid` on ``device`` (the card when None).  The FPGA
    family's integer channels come as uint8, as the JAX package gives
    them; grad_hist's as float32."""
    for chns, scale in compute_pyramid(image, channel_opts, device):
        yield np.ascontiguousarray(chns.permute(1, 2, 0).cpu().numpy()), scale
