"""The one generator of frames: a traffic file's parameters and a seed
give the pool of frames a cell cycles through.

A traffic file (``wbbench/workloads/<traffic>.json``) names a frame kind
and its parameters; the configuration gives the frame size.

* ``"noise"``: uniform uint8 noise, drawn on the device by a
  ``torch.Generator`` seeded with the seed;
* ``"scenes"``: :func:`scene`, bright rectangles over several octaves of
  size and aspect, textured clutter and scaled noise (``max_objects``,
  ``octaves``, ``base_side``, ``aspect``, ``clutter``, ``noise``), drawn
  by numpy from a 32-bit seed derived from the seed.  Every seed gets
  the same counts: frame ``p`` of call ``b`` (``batch`` frames a call)
  has ``p % (max_objects + 1)`` objects, ``(b + p) % (clutter + 1)``
  clutter patches and a noise gain of ``frac(0.618... i)`` for its index
  ``i`` in the pool; the seed draws the rest (sizes, places, textures,
  the noise field).

The same seed gives the same pool.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_pool", "scene", "seed32"]


def seed32(seed: int) -> int:
    """A 32-bit seed of any whole number (numpy's legacy generator takes
    no more than 32 bits)."""
    return int(np.random.SeedSequence(abs(int(seed)),
                                      spawn_key=(int(seed < 0),))
               .generate_state(1)[0])


def scene(rng: np.random.RandomState, hw, max_objects=3, octaves=3,
          base_side=18, aspect=(0.7, 1.45), clutter=5, noise=0.3,
          counts=None) -> np.ndarray:
    """One (h, w) uint8 scene.  The draw order (clutter patches, objects,
    noise) defines the frames and must not change.  ``counts``: the
    clutter patches, objects and noise gain to use in place of drawing
    them."""
    h, w = hw
    field = np.zeros((h, w), np.float32)
    n_clutter = rng.randint(clutter + 1) if counts is None else counts[0]
    for _ in range(n_clutter):
        side = rng.randint(12, max(h, w) // 3)
        cw = max(int(side * rng.uniform(*aspect)), 4)
        y0 = rng.randint(max(h - side, 1))
        x0 = rng.randint(max(w - cw, 1))
        kind = rng.randint(3)
        amp = rng.uniform(0.1, 0.45)
        yy, xx = np.mgrid[0:side, 0:cw]
        if kind == 0:      # diagonal stripes
            tex = 0.5 * (1 + np.sin((xx + yy) * (2 * np.pi /
                                                 rng.randint(4, 16))))
        elif kind == 1:    # horizontal ramp
            tex = xx / max(cw - 1, 1)
        else:              # blob
            cy, cx = side / 2, cw / 2
            tex = np.clip(1 - np.hypot(yy - cy, xx - cx) / max(cy, cx), 0, 1)
        patch = field[y0:y0 + side, x0:x0 + cw]
        patch += amp * tex[:patch.shape[0], :patch.shape[1]].astype(
            np.float32)
    n_objects = rng.randint(max_objects + 1) if counts is None \
        else counts[1]
    for _ in range(n_objects):
        octv = rng.randint(octaves)
        side = int(base_side * 2 ** (octv + rng.uniform(0, 1)))
        ow = max(int(side * rng.uniform(*aspect)), 6)
        if side >= h - 1 or ow >= w - 1:
            continue
        y0 = rng.randint(h - side)
        x0 = rng.randint(w - ow)
        field[y0:y0 + side, x0:x0 + ow] += rng.uniform(0.25, 1)
        rng.rand()  # the ignore flag's draw, kept for the draw order
    field += rng.rand(h, w) * noise * (rng.rand() if counts is None
                                       else counts[2])
    return (np.clip(field, 0.0, 1.0) * 255).astype(np.uint8)


def strata(n_frames: int, batch: int, max_objects: int, clutter: int):
    """The (clutter patches, objects, noise gain) of each frame of a
    pool of scenes."""
    golden = (5 ** 0.5 - 1) / 2
    return [((i // batch + i % batch) % (clutter + 1),
             (i % batch) % (max_objects + 1), (i * golden) % 1.0)
            for i in range(n_frames)]


def make_pool(traffic: dict, frame_hw, n_frames: int, seed: int,
              device, batch: int = 1) -> torch.Tensor:
    """(n_frames, H, W) uint8 frames of a traffic mix on ``device``, in
    calls of ``batch`` frames."""
    h, w = (int(v) for v in frame_hw)
    kind = traffic["frames"]
    if kind == "noise":
        g = torch.Generator(device=device)
        g.manual_seed(int(seed) % (1 << 63))
        return torch.randint(0, 256, (n_frames, h, w), generator=g,
                             dtype=torch.uint8, device=device)
    if kind == "scenes":
        params = dict(traffic.get("scene", {}))
        if "aspect" in params:
            params["aspect"] = tuple(params["aspect"])
        rng = np.random.RandomState(seed32(seed))
        frames = np.stack([scene(rng, (h, w), counts=c, **params)
                           for c in strata(n_frames, batch,
                                           params.get("max_objects", 3),
                                           params.get("clutter", 5))])
        return torch.from_numpy(frames).to(device)
    raise ValueError(f"unknown frame kind {kind!r}")
