"""Write the golden outputs of two-phase and row-wise batched serving.

Runs the JAX package on the CPU: ``make_batched_detector_boxes`` of the
committed flagship ``models/flagship_synth_64.pb`` on VGA frames, three
seeded noise frames (``numpy.random.RandomState(NOISE_SEED)``) and the
three ``scene_generator(seed=100)`` frames of
``tests/data/torch_port_vga_golden.npz``, one batch of six:

* ``tp``: ``two_phase=True`` at JAX's defaults (prefix 12, capacity
  8192), k=1024, no NMS;
* ``tpo``: ``two_phase=True, prefix=OVER_PREFIX, capacity=OVER_CAPACITY``
  (more prefix survivors than the capacity on every frame), k=1024;
* ``row``: ``extractor="rowwise", k_row=16, k=1024, nms_iou=0.5``.

Each run's five outputs (rects, scores, valid, count, n_weak) are saved
whole, slot order included, to ``tests/data/torch_port_twophase_golden.npz``
with the frames' SHA-256.  ``chip_smoke.py`` phase 9a holds the port to
them bitwise on the card.

Usage (from the repository root, about a minute):

    python scripts/make_torch_twophase_golden.py
"""

import argparse
import hashlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOISE_SEED = 21
OVER_PREFIX, OVER_CAPACITY = 2, 512
#: name -> make_batched_detector_boxes keywords of each golden run
RUNS = {
    "tp": dict(k=1024, two_phase=True),
    "tpo": dict(k=1024, two_phase=True, prefix=OVER_PREFIX,
                capacity=OVER_CAPACITY),
    "row": dict(k=1024, extractor="rowwise", k_row=16, nms_iou=0.5),
}
OUTPUTS = ("rects", "scores", "valid", "count", "n_weak")


def golden_frames(root=ROOT):
    """The six (480, 640) uint8 frames: seeded noise, then the VGA
    golden's scenes."""
    noise = np.random.RandomState(NOISE_SEED).randint(
        0, 256, (3, 480, 640)).astype(np.uint8)
    scenes = np.load(os.path.join(root, "tests", "data",
                                  "torch_port_vga_golden.npz"))["frames"]
    return np.ascontiguousarray(np.concatenate([noise, scenes]))


def frames_digest(frames) -> str:
    return hashlib.sha256(np.ascontiguousarray(frames).tobytes()).hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_port_twophase_golden.npz"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    sys.path.insert(0, ROOT)
    import waldboost_tpu as wb
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    model = wb.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"))
    frames = golden_frames()
    out = {"frames_sha256": np.array(frames_digest(frames))}
    for name, kw in RUNS.items():
        t0 = time.time()
        fn, _ = make_batched_detector_boxes(model, frames.shape[1:], **kw)
        res = [np.asarray(a) for a in fn(jnp.asarray(frames.copy()))]
        for o, a in zip(OUTPUTS, res):
            out[f"{name}_{o}"] = a
        print(f"{name}: count {res[3].tolist()}, valid "
              f"{res[2].sum(axis=1).tolist()}, n_weak {res[4].tolist()} "
              f"({time.time() - t0:.1f} s)", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
