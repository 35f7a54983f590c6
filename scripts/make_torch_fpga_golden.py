"""Write the golden BASELINE config-5 outputs the PyTorch port is held to.

Runs the JAX package on the CPU over seeded uniform-noise frames (3840x2160
uint8 by default; the file records the numpy seed, not the pixels) with
both committed FPGA models (``models/fpga_4k_synth_64.pb``, smooth 0, and
``models/fpga_4k_smooth_synth_64.pb``, smooth 1) and records per model:

* the full 64-stage cascade: ``make_batched_detector_boxes(k=1024,
  nms_iou=0.5)`` survivor counts and n_weak, and ``Model.detect``'s
  survivor count with its n_weak / n_loc counters;
* a prefix of the cascade (its first P stages and thetas as a ``Model``;
  P = 16 unless a frame then has no survivor or more than 1024, or NMS
  drops nothing, in which case the nearest length that gives every frame
  1..1024 survivors and NMS work is taken and recorded; the survivors of
  every length come from ``Model.survivor_histogram``):
  ``make_batched_detector_boxes(k=1024, nms_iou=0.5)`` counts, n_weak and
  kept boxes and scores, the boxes the JAX package's host NMS
  (``boxes.non_max_suppression``) keeps of the same survivors, and
  ``Model.detect``'s survivors with their scores and counters;
* ``make_batched_detector(n_stages_cap=P)`` of the full cascade: alive
  count and n_weak per frame.

Rows are concatenated over frames and split by the ``*_counts`` arrays;
rows of one frame keep JAX's order (compare them sorted).  Written to
``tests/data/torch_port_fpga_golden.npz``.

Usage (from the repository root; JAX on 4K frames wants several GB of
memory and some minutes, so run it on a large machine):

    python scripts/make_torch_fpga_golden.py [--hw 2160 3840] [--out PATH]
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("fpga_4k_synth_64", "fpga_4k_smooth_synth_64")
SEED = 0
N_FRAMES = 2
K = 1024
NMS_IOU = 0.5
PREFIX = 16


def _rows(rects, scores):
    return np.concatenate([np.asarray(rects, np.float32).reshape(-1, 4),
                           np.asarray(scores, np.float32).reshape(-1, 1)], 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(2160, 3840))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_port_fpga_golden.npz"))
    args = ap.parse_args()
    hw = tuple(args.hw)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    sys.path.insert(0, ROOT)
    import waldboost_tpu as wb
    from waldboost_tpu import boxes as bbx
    from waldboost_tpu.parallel.detect import (make_batched_detector,
                                               make_batched_detector_boxes)

    frames = np.random.RandomState(SEED).randint(
        0, 256, (N_FRAMES,) + hw).astype(np.uint8)
    frames_j = jnp.asarray(frames)
    out = {"seed": np.int64(SEED), "n_frames": np.int64(N_FRAMES),
           "hw": np.asarray(hw, np.int64), "k": np.int64(K),
           "nms_iou": np.float32(NMS_IOU)}

    def boxes_run(model):
        fn, _ = make_batched_detector_boxes(model, hw, k=K, nms_iou=NMS_IOU)
        return [np.asarray(a) for a in fn(frames_j)]

    def raw_run(model):
        fn, _ = make_batched_detector_boxes(model, hw, k=K)
        return [np.asarray(a) for a in fn(frames_j)]

    def detect_run(model):
        rows, n_weak, n_loc = [], [], []
        for img in frames:
            model.reset()
            b = model.detect(img)
            rows.append(_rows(b.get(), b.get_field("scores")))
            n_weak.append(model.n_weak)
            n_loc.append(model.n_loc)
        return rows, np.asarray(n_weak, np.int64), np.asarray(n_loc, np.int64)

    for name in MODELS:
        t0 = time.time()
        model = wb.load(os.path.join(ROOT, "models", name + ".pb"))
        _, _, _, count, n_weak = boxes_run(model)
        out[f"{name}_full_count"] = count.astype(np.int32)
        out[f"{name}_full_n_weak"] = n_weak.astype(np.int64)
        rows, dnw, dnl = detect_run(model)
        out[f"{name}_full_detect_counts"] = np.asarray([len(r) for r in rows],
                                                      np.int32)
        out[f"{name}_full_detect_n_weak"] = dnw
        out[f"{name}_full_detect_n_loc"] = dnl
        print(f"{name}: full cascade survivors {count.tolist()}, n_weak "
              f"{n_weak.tolist()}, Model.detect {[len(r) for r in rows]} "
              f"({time.time() - t0:.1f} s)", flush=True)

        # survivors after each prefix length: windows alive entering stage P
        hist = np.stack([model.survivor_histogram(img) for img in frames])
        cands = [p for p in sorted(range(1, len(model)),
                                   key=lambda p: (abs(p - PREFIX), p))
                 if ((hist[:, p] >= 1) & (hist[:, p] <= K)).all()]
        print(f"{name}: prefix lengths with 1..{K} survivors on every "
              f"frame: {sorted(cands)}", flush=True)
        ok = False
        for P in cands:
            prefix = wb.Model(model.shape, model.channel_opts)
            for weak, theta in list(model)[:P]:
                prefix.append(weak, theta)
            rects, scores, valid, count, n_weak = boxes_run(prefix)
            assert np.array_equal(count, hist[:, P])
            ok = bool((valid.sum(1) < count).any())
            print(f"{name}: prefix {P}: survivors {count.tolist()}, kept "
                  f"{valid.sum(1).tolist()}{'' if ok else ' (rejected)'} "
                  f"({time.time() - t0:.1f} s)", flush=True)
            if ok:
                break
        assert ok, f"{name}: no prefix length gives 1..{K} survivors " \
            "and NMS work on every frame"
        r_raw, s_raw, v_raw, c_raw, _ = raw_run(prefix)
        assert np.array_equal(c_raw, count)
        kept, host = [], []
        for b in range(N_FRAMES):
            kept.append(_rows(rects[b][valid[b]], scores[b][valid[b]]))
            cand = bbx.Boxes(r_raw[b][v_raw[b]])
            cand.set_field("scores", s_raw[b][v_raw[b]])
            hk = bbx.non_max_suppression(cand, iou_threshold=NMS_IOU)
            host.append(_rows(hk.get(), hk.get_field("scores")))
        agree = [len(a) == len(h) and np.array_equal(
            a[np.lexsort(a.T[::-1])], h[np.lexsort(h.T[::-1])])
            for a, h in zip(kept, host)]
        out[f"{name}_prefix_stages"] = np.int64(P)
        out[f"{name}_prefix_count"] = count.astype(np.int32)
        out[f"{name}_prefix_n_weak"] = n_weak.astype(np.int64)
        for key, rows in (("kept", kept), ("kept_host", host)):
            out[f"{name}_prefix_{key}_rows"] = np.concatenate(rows)
            out[f"{name}_prefix_{key}_counts"] = np.asarray(
                [len(r) for r in rows], np.int32)
        rows, dnw, dnl = detect_run(prefix)
        out[f"{name}_prefix_detect_rows"] = np.concatenate(rows)
        out[f"{name}_prefix_detect_counts"] = np.asarray(
            [len(r) for r in rows], np.int32)
        out[f"{name}_prefix_detect_n_weak"] = dnw
        out[f"{name}_prefix_detect_n_loc"] = dnl
        fn, _ = make_batched_detector(model, hw, n_stages_cap=P)
        _, alive, cap_nw = (np.asarray(a) for a in fn(frames_j))
        out[f"{name}_cap_alive"] = alive.sum(axis=(1, 2)).astype(np.int64)
        out[f"{name}_cap_n_weak"] = cap_nw.astype(np.int64)
        print(f"{name}: prefix {P}: kept {[len(r) for r in kept]} (host NMS "
              f"{[len(r) for r in host]}, equal {agree}), Model.detect "
              f"{[len(r) for r in rows]}, n_stages_cap alive "
              f"{out[f'{name}_cap_alive'].tolist()} "
              f"({time.time() - t0:.1f} s)", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
