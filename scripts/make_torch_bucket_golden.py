"""Write the golden detections of bucketed serving and of exact float
frames that the PyTorch port is held against.

Runs the JAX package on the CPU, in-repo, with nothing to download, with
the committed flagship ``models/flagship_synth_64.pb``:

* ``tests/data/torch_port_bucket_golden.npz``: JAX's ``BucketedDetector``
  (``bucket=128``, ``k=1024``, NMS 0.5) on uint8 frames of
  ``utils.scene_generator(seed=SEED, hw=...)`` at 640x480, 600x448 and
  576x432 (one bucket, 512 x 640) and at 1280x720 (bucket 768 x 1280),
  one frame per size (the frames are saved, as ``frame_<h>x<w>``).  Per
  frame the survivor count of the bucket program and the kept boxes and
  scores (rows ``x0, y0, x1, y1, score``).
* ``tests/data/torch_port_float_golden.npz``: the 3 scene frames of
  ``tests/data/torch_port_vga_golden.npz`` as float32, through
  ``make_batched_detector_boxes(k=1024, nms_iou=0.5)`` (counts, kept rows
  split by ``batched_kept_counts``) and ``Model.detect`` (raw survivors,
  rows split by ``detect_counts``), exact mode.

Usage (from the repository root; a few minutes on a CPU):

    python scripts/make_torch_bucket_golden.py [--only bucket|float]
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 21
BUCKET, K, NMS_IOU = 128, 1024, 0.5
#: (h, w) of the bucket golden's frames
SIZES = ((480, 640), (448, 600), (432, 576), (720, 1280))


def rows_of(rects, scores, valid):
    return np.concatenate([rects[valid], scores[valid][:, None]], 1) \
        .astype(np.float32)


def bucket_golden(wb, model, out_path):
    import jax.numpy as jnp

    from waldboost_tpu.parallel.bucket import BucketedDetector
    from waldboost_tpu.utils import scene_generator

    det = BucketedDetector(model, bucket=BUCKET, k=K, nms_iou=NMS_IOU)
    out = dict(seed=np.int32(SEED), bucket=np.int32(BUCKET), k=np.int32(K),
               nms_iou=np.float32(NMS_IOU))
    for h, w in SIZES:
        t0 = time.time()
        frame = next(scene_generator(seed=SEED, hw=(h, w)))["image"]
        assert frame.dtype == np.uint8 and frame.shape == (h, w)
        bucket_hw = det._snap(h, w)
        fn = det._fn(bucket_hw)
        g = det._geom(bucket_hw, (h, w), True)
        batch = np.zeros((1,) + bucket_hw, np.uint8)
        batch[0, :h, :w] = frame
        rects, scores, valid, count, _, _ = (
            np.asarray(a) for a in fn(jnp.asarray(batch), g))
        assert count[0] >= 0, "overflow: raise K"
        rows = rows_of(rects[0], scores[0], valid[0])
        # the front end's own answer is the same rows
        kept = det.detect(frame)
        want = np.concatenate([kept.get(), kept.get_field("scores")[:, None]],
                              1).astype(np.float32)
        assert np.array_equal(rows[np.lexsort(rows.T[::-1])],
                              want[np.lexsort(want.T[::-1])])
        key = f"{h}x{w}"
        out[f"frame_{key}"] = frame
        out[f"count_{key}"] = np.int32(count[0])
        out[f"kept_{key}"] = rows
        print(f"bucket {bucket_hw} frame {key}: {int(count[0])} survivors, "
              f"{len(rows)} kept ({time.time() - t0:.1f} s)")
    print(f"bucket set-ups: {det.compiles}")
    np.savez_compressed(out_path, **out)


def float_golden(wb, model, out_path):
    import jax.numpy as jnp

    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    scenes = np.load(os.path.join(ROOT, "tests", "data",
                                  "torch_port_vga_golden.npz"))["frames"]
    frames = scenes.astype(np.float32)
    t0 = time.time()
    fn, _ = make_batched_detector_boxes(model, frames.shape[1:], k=K,
                                        nms_iou=NMS_IOU)
    rects, scores, valid, count, _ = (np.asarray(a)
                                      for a in fn(jnp.asarray(frames)))
    kept = [rows_of(rects[b], scores[b], valid[b]) for b in range(len(frames))]
    print(f"batched: {count.tolist()} survivors, "
          f"{[len(r) for r in kept]} kept ({time.time() - t0:.1f} s)")
    t0 = time.time()
    raw = []
    for f in frames:
        bx = model.detect(f)
        raw.append(np.concatenate([bx.get(), bx.get_field("scores")[:, None]],
                                  1).astype(np.float32))
    print(f"Model.detect: {[len(r) for r in raw]} survivors "
          f"({time.time() - t0:.1f} s)")
    np.savez_compressed(
        out_path, k=np.int32(K), nms_iou=np.float32(NMS_IOU),
        batched_counts=count.astype(np.int32),
        batched_kept=np.concatenate(kept),
        batched_kept_counts=np.array([len(r) for r in kept], np.int32),
        detect_rows=np.concatenate(raw),
        detect_counts=np.array([len(r) for r in raw], np.int32))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("bucket", "float"), default=None)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "tests", "data"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import waldboost_tpu as wb

    model = wb.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"))
    if args.only in (None, "bucket"):
        bucket_golden(wb, model, os.path.join(
            args.out_dir, "torch_port_bucket_golden.npz"))
    if args.only in (None, "float"):
        float_golden(wb, model, os.path.join(
            args.out_dir, "torch_port_float_golden.npz"))


if __name__ == "__main__":
    main()
