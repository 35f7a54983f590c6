"""Write the fast-serving-mode golden detections the PyTorch port is held
against.

Runs the JAX package on the CPU, in-repo, with nothing to download: its
``make_batched_detector_boxes`` built under ``WB_SERVING_MODE=fast`` with
the Pallas channel kernel (interpret mode) on the committed flagship
``models/flagship_synth_64.pb`` at VGA, ``k=1024``, NMS 0.5,
``with_n_weak=False``, over

* ``uint8``: the 3 scene frames of ``tests/data/torch_port_vga_golden.npz``;
* ``float_f32``: float32 versions of them, each frame plus uniform [0, 1)
  noise from ``numpy.random.RandomState(SEED)``, f32 planes;
* ``float_bf16``: the same float32 frames under ``WB_FAST_FLOAT=bf16``.

Per variant it saves the survivor counts and the kept boxes and scores
(rows ``x0, y0, x1, y1, score`` concatenated over frames, split by
``<variant>_kept_counts``) to ``tests/data/torch_port_fast_golden.npz``;
the frames are not repeated there.

Usage (from the repository root; a few minutes on a CPU):

    python scripts/make_torch_fast_golden.py
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7       # the float frames' noise
K, NMS_IOU = 1024, 0.5


def float_frames(frames: np.ndarray, seed: int = SEED) -> np.ndarray:
    """The float32 versions of the uint8 scene frames."""
    noise = np.random.RandomState(seed).rand(*frames.shape)
    return frames + noise.astype(np.float32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_port_fast_golden.npz"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp

    import waldboost_tpu as wb
    from waldboost_tpu import model as JM
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    scenes = np.load(os.path.join(ROOT, "tests", "data",
                                  "torch_port_vga_golden.npz"))["frames"]
    model = wb.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"))
    JM.set_channel_backend("pallas")  # B2f, B3f in interpret mode
    os.environ["WB_SERVING_MODE"] = "fast"
    out = dict(k=np.int32(K), nms_iou=np.float32(NMS_IOU),
               seed=np.int32(SEED))
    for key, frames, fast_float in (
            ("uint8", scenes, None),
            ("float_f32", float_frames(scenes), None),
            ("float_bf16", float_frames(scenes), "bf16")):
        t0 = time.time()
        os.environ.pop("WB_FAST_FLOAT", None)
        if fast_float:
            os.environ["WB_FAST_FLOAT"] = fast_float
        fn, _ = make_batched_detector_boxes(model, frames.shape[1:], k=K,
                                            nms_iou=NMS_IOU,
                                            with_n_weak=False)
        rects, scores, valid, count, _ = (
            np.asarray(a) for a in fn(jnp.asarray(frames)))
        rows = [np.concatenate([rects[b][valid[b]],
                                scores[b][valid[b]][:, None]], 1)
                for b in range(len(frames))]
        out[key + "_counts"] = count.astype(np.int32)
        out[key + "_kept"] = np.concatenate(rows).astype(np.float32)
        out[key + "_kept_counts"] = np.asarray([len(r) for r in rows],
                                               np.int32)
        print(f"{key}: survivors {count.tolist()}, kept "
              f"{[len(r) for r in rows]} ({time.time() - t0:.1f} s)",
              flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
