"""Channel functions, the static pyramid plan and the uint8 octave chain.

Counterpart of ``waldboost_tpu/channels.py``.  The pyramid plan is the same
host arithmetic (level sizes snapped with ``int((w*s)/shrink)*shrink``), and
the registry knows the channel functions the port serves: ``grad_hist``
here, the FPGA integer family in ``fpga/channels.py`` (imported at the
first lookup that misses), and ``"a+b"`` composites of either family.  The
octave chain is plain integer torch on the caller's device.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["ChannelFunction", "Level", "grad_hist", "pyramid_plan",
           "register_channel_function", "resolve_channel_function",
           "compose_channel_functions", "octave_chain"]


@dataclasses.dataclass(frozen=True)
class ChannelFunction:
    """What the port needs to know of a channel function: its canonical
    name (written into saved models), channel count, the image-space halo
    its stencils read around each level, how a level's edge is read
    (``boundary``: ``"reflect"`` halos or the FPGA family's
    ``"stencil_zero"`` ring), and the FPGA response kind (``fused_kind``,
    kernel B5's ``kind``; None for the float family)."""

    name: str
    n_channels: int
    aliases: Tuple[str, ...] = ()
    halo: int = 1
    boundary: str = "reflect"
    fused_kind: Optional[str] = None


_REGISTRY: Dict[str, ChannelFunction] = {}

#: names of the JAX package's float ``grad_mag``, whose canvas is not ported
_UNPORTED = ("waldboost_tpu.channels.grad_mag", "grad_mag",
             "waldboost.channels.grad_mag", "waldboost.nb_channels.grad_mag")


def register_channel_function(cf: ChannelFunction) -> ChannelFunction:
    for key in (cf.name,) + tuple(cf.aliases):
        _REGISTRY[key] = cf
    return cf


grad_hist = register_channel_function(ChannelFunction(
    name="waldboost_tpu.channels.grad_hist",
    n_channels=4,
    aliases=("grad_hist", "waldboost.channels.grad_hist",
             "waldboost.nb_channels.grad_hist"),
    halo=1,
))


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
    if name in _UNPORTED:
        raise NotImplementedError(
            f"channel function {name!r} is not ported yet: the float "
            f"grad_mag canvas is ROADMAP item A14")
    if isinstance(name, str) and "+" in name:
        return compose_channel_functions(*name.split("+"))
    raise KeyError(f"Unknown channel function {name!r}. Registered: "
                   f"{sorted(set(cf.name for cf in _REGISTRY.values()))}")


def compose_channel_functions(*parts) -> ChannelFunction:
    """Channel functions stacked along the channel axis in argument order,
    registered under ``"+".join`` of the parts' canonical names (the name
    the JAX package writes into model files) with the given spelling as an
    alias.  FPGA parts compose into one B5 kind."""
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
    return register_channel_function(ChannelFunction(
        name=name,
        n_channels=sum(cf.n_channels for cf in cfs),
        aliases=("+".join(getattr(p, "name", p) for p in parts),),
        halo=max(cf.halo for cf in cfs),
        boundary=cfs[0].boundary,
        fused_kind=fused,
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


def octave_chain(images: torch.Tensor, n_octaves: int) -> List[torch.Tensor]:
    """uint8 octave images of a (B, H, W) uint8 batch.

    Each octave is the 2x2 average pool of the previous one with the uint8
    reference's arithmetic: the row pair sum wraps mod 256, then the column
    pair sum wraps mod 256, then ``floor(/4)``; an odd last row or column
    is dropped.
    """
    if images.dtype != torch.uint8 or images.dim() != 3:
        raise ValueError("octave_chain takes a (B, H, W) uint8 tensor")
    octaves = [images]
    for _ in range(n_octaves - 1):
        prev = octaves[-1]
        h, w = prev.shape[1] // 2 * 2, prev.shape[2] // 2 * 2
        x = prev[:, :h, :w].to(torch.int32)
        rows = (x[:, 0::2] + x[:, 1::2]) % 256
        cols = (rows[:, :, 0::2] + rows[:, :, 1::2]) % 256
        octaves.append((cols // 4).to(torch.uint8))
    return octaves
