"""Write the models and the golden outputs of the image-space canvas and
of CNN-verified serving, which the PyTorch port is held against.

Runs the JAX package on the CPU, in this repository, with nothing to
download:

1. three synthetic 64-stage cascades built as ``bench.py`` builds its
   flagship (``__graft_entry__._flagship_model``: depth-2 trees,
   thresholds from seeded channel samples of a 256 x 320 noise frame,
   thetas from the survivor-quantile calibration), saved under
   ``tests/data/``:

   * ``torch_port_s1_synth_64.pb``: grad_hist at ``shrink=1`` (24 x 24 x 4,
     the flagship's pixel window), ``n_per_oct=8, smooth=1``;
   * ``torch_port_grad_mag_synth_64.pb``: grad_mag at ``shrink=2``
     (12 x 12 x 1), ``n_per_oct=8, smooth=1``;
   * ``torch_port_hist_mag_synth_64.pb``: the ``grad_hist+grad_mag``
     composite (12 x 12 x 5), the same options;

2. a CNN verifier for the flagship's 12 x 12 x 4 windows, trained with
   ``verification.train`` on the pools of an 8-stage detector trained on
   ``fake_data_generator(seed=11)`` (the recipe of
   ``tests/test_verification.py::test_verifier_does_not_degrade_auc``);

3. ``tests/data/torch_port_canvas_golden.npz``: on the three VGA scene
   frames of ``tests/data/torch_port_vga_golden.npz`` and two VGA noise
   frames (``RandomState(NOISE_SEED)``), each model's ``Model.detect``
   survivors (boxes and scores, counts, n_weak) and the boxes the host
   ``non_max_suppression(0.5)`` keeps (the shrink-1 and composite
   cascades, calibrated on noise, keep no window of the scenes); the
   shrink-1 model also on :func:`float_frames`; the verifier's parameters (flattened
   keys ``verifier/<layer>/<leaf>``); ``detect_and_verify`` of the
   committed ``models/flagship_synth_64.pb`` on the scene frames (boxes,
   verified and cascade scores), and the fused ``BucketedDetector(k=1024,
   nms_iou=0.5, verifier=...)`` on them.

Rows are concatenated over frames and split by the ``*_counts`` arrays.

Usage (from the repository root; about five minutes on one CPU):

    python scripts/make_torch_canvas_golden.py
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
VGA = (480, 640)
NOISE_SEED = 1234
#: (file stem, channel options, window) of the three cascades
MODELS = (
    ("torch_port_s1_synth_64", dict(shrink=1, n_per_oct=8, smooth=1,
                                    channels="grad_hist"), (24, 24, 4)),
    ("torch_port_grad_mag_synth_64", dict(shrink=2, n_per_oct=8, smooth=1,
                                          channels="grad_mag"), (12, 12, 1)),
    ("torch_port_hist_mag_synth_64", dict(shrink=2, n_per_oct=8, smooth=1,
                                          channels="grad_hist+grad_mag"),
     (12, 12, 5)),
)


def noise_frames():
    rng = np.random.RandomState(NOISE_SEED)
    return rng.randint(0, 256, (2,) + VGA).astype(np.uint8)


def float_frames():
    """The first noise frame as float32 with a quarter added: the float
    resize's fractions do not vanish."""
    return noise_frames()[:1].astype(np.float32) + np.float32(0.25)


def add_rows(out, key, rows_per_frame, cols):
    """``out[key_counts]`` and each column of ``cols`` concatenated."""
    out[f"{key}_counts"] = np.asarray([len(r[0]) for r in rows_per_frame],
                                      np.int32)
    for i, col in enumerate(cols):
        out[f"{key}_{col}"] = np.concatenate([r[i] for r in rows_per_frame])


def detections(model, frames, wb):
    """Per frame ``(raw rects, raw scores)``, ``(kept rects, kept
    scores)`` and n_weak of Model.detect then host NMS 0.5."""
    raw, kept, n_weak = [], [], []
    for img in frames:
        model.reset()
        b = model.detect(img)
        k = wb.bbx.non_max_suppression(b, iou_threshold=0.5)
        raw.append((np.asarray(b.get(), np.float32).reshape(-1, 4),
                    np.asarray(b.get_field("scores"), np.float32)))
        kept.append((np.asarray(k.get(), np.float32).reshape(-1, 4),
                     np.asarray(k.get_field("scores"), np.float32)))
        n_weak.append(model.cost_stats()["n_weak"])
    return raw, kept, np.asarray(n_weak, np.int64)


def flatten(tree, prefix="verifier"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        DATA, "torch_port_canvas_golden.npz"))
    ap.add_argument("--model-dir", default=DATA)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import waldboost_tpu as wb
    from __graft_entry__ import _flagship_model
    from waldboost_tpu import verification as V
    from waldboost_tpu.parallel.bucket import BucketedDetector
    from waldboost_tpu.utils import fake_data_generator

    scenes = np.load(os.path.join(DATA, "torch_port_vga_golden.npz"))[
        "frames"]
    frames = np.concatenate([scenes, noise_frames()])
    out = dict(noise_seed=np.int64(NOISE_SEED), n_scenes=np.int64(
        len(scenes)))
    for stem, opts, shape in MODELS:
        t0 = time.time()
        model = _flagship_model(channel_opts=opts, shape=shape)
        path = os.path.join(args.model_dir, stem + ".pb")
        model.save(path)
        model = wb.load(path)
        raw, kept, n_weak = detections(model, frames, wb)
        key = stem.replace("torch_port_", "").replace("_synth_64", "")
        add_rows(out, f"{key}_raw", raw, ("rects", "scores"))
        add_rows(out, f"{key}_kept", kept, ("rects", "scores"))
        out[f"{key}_n_weak"] = n_weak
        print(f"{stem}: {len(model)} stages, survivors "
              f"{out[key + '_raw_counts'].tolist()}, kept "
              f"{out[key + '_kept_counts'].tolist()} "
              f"({time.time() - t0:.1f} s)", flush=True)
        if key == "s1":
            fraw, fkept, _ = detections(model, float_frames(), wb)
            add_rows(out, "s1f_raw", fraw, ("rects", "scores"))
            add_rows(out, "s1f_kept", fkept, ("rects", "scores"))

    # the verifier: the pools of an 8-stage detector, then a few epochs
    t0 = time.time()
    det = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=4, smooth=1,
                                     channels="grad_hist"))
    pool = wb.SamplePool(min_tp=300, min_fp=300, seed=0)
    wb.train(det, fake_data_generator(seed=11), pool=pool, length=8,
             learner=wb.Learner(alpha=0.2, max_depth=2))
    X0, H0 = pool.get_false_positives()
    X1, H1 = pool.get_true_positives()
    module, params = V.init_verifier((12, 12, 4), seed=0)
    params = V.train(module, params, X0, H0, X1, H1, epochs=3, steps=150,
                     batch_size=64, lr=1e-3, seed=0, verbose=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    out.update(flatten(params))
    print(f"verifier trained on {len(X0)} + {len(X1)} crops "
          f"({time.time() - t0:.1f} s)", flush=True)

    t0 = time.time()
    flagship = wb.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"))
    rows = []
    for img in scenes:
        b = V.detect_and_verify(img, flagship, module, params)
        rows.append((np.asarray(b.get(), np.float32).reshape(-1, 4),
                     np.asarray(b.get_field("scores"), np.float32),
                     np.asarray(b.get_field("cascade_scores"), np.float32)))
    add_rows(out, "ver", rows, ("rects", "scores", "cascade_scores"))
    bdet = BucketedDetector(flagship, bucket=128, k=1024, nms_iou=0.5,
                            verifier=(module, params))
    rows = [(np.asarray(b.get(), np.float32).reshape(-1, 4),
             np.asarray(b.get_field("scores"), np.float32),
             np.asarray(b.get_field("cascade_scores"), np.float32))
            for b in bdet.detect_many(list(scenes))]
    add_rows(out, "vbk", rows, ("rects", "scores", "cascade_scores"))
    print(f"verified detection: {out['ver_counts'].tolist()} windows, "
          f"fused bucket kept {out['vbk_counts'].tolist()} "
          f"({time.time() - t0:.1f} s)", flush=True)

    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
