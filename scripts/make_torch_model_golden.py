"""Write the golden Model-API outputs the PyTorch port is held against.

Runs the JAX package on the CPU over the 3 VGA scene frames of
``tests/data/torch_port_vga_golden.npz`` with each committed model
(``models/flagship_synth_64.pb``, ``flagship_hard_64.pb``,
``flagship_hard_256.pb``) and records, per model and frame:

* ``Model.detect``: every survivor's box and score, and the model's
  ``n_weak`` and ``n_loc`` counters of that call;
* ``Model.detect_topk(k=1024, nms_iou=0.5)``: the kept boxes and scores;
* ``Model.scan_packed``: the survivors' canvas origins ``(rs, cs)``, their
  scores, and the counters;

and ``wb.detect(frame, *models, response_scale=[1, 0.5, 2])``: boxes,
scaled scores and labels.  Rows are concatenated over frames and split by
the ``*_counts`` arrays; rows of one frame keep the order JAX returned
them in (compare them sorted).  Written to
``tests/data/torch_port_model_golden.npz``.

Usage (from the repository root; a few minutes on one CPU):

    python scripts/make_torch_model_golden.py
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("flagship_synth_64", "flagship_hard_64", "flagship_hard_256")
RESPONSE_SCALE = (1.0, 0.5, 2.0)
TOPK = 1024
NMS_IOU = 0.5


def _rows(boxes, *fields):
    cols = [np.asarray(boxes.get(), np.float32).reshape(-1, 4)]
    cols += [np.asarray(boxes.get_field(f), np.float32).reshape(-1, 1)
             for f in fields]
    return np.concatenate(cols, axis=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_port_model_golden.npz"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import waldboost_tpu as wb

    frames = np.load(os.path.join(ROOT, "tests", "data",
                                  "torch_port_vga_golden.npz"))["frames"]
    models = {name: wb.load(os.path.join(ROOT, "models", name + ".pb"))
              for name in MODELS}
    out = {"frames": frames.astype(np.uint8),
           "response_scale": np.asarray(RESPONSE_SCALE, np.float32),
           "topk_k": np.int32(TOPK), "nms_iou": np.float32(NMS_IOU)}
    for name, model in models.items():
        rec = {k: [] for k in ("detect", "n_weak", "n_loc", "topk", "scan",
                               "scan_n_weak")}
        for i, img in enumerate(frames):
            t0 = time.time()
            model.reset()
            rec["detect"].append(_rows(model.detect(img), "scores"))
            rec["n_weak"].append(model.n_weak)
            rec["n_loc"].append(model.n_loc)
            rec["topk"].append(_rows(model.detect_topk(img, k=TOPK,
                                                       nms_iou=NMS_IOU),
                                     "scores"))
            model.reset()
            _, _, rs, cs, sc = model.scan_packed(img)
            rec["scan"].append(np.stack([rs.astype(np.float32),
                                         cs.astype(np.float32),
                                         np.asarray(sc, np.float32)], 1))
            rec["scan_n_weak"].append(model.n_weak)
            print(f"{name} frame {i}: {len(rec['detect'][-1])} survivors, "
                  f"{len(rec['topk'][-1])} kept, {len(rs)} scan survivors "
                  f"({time.time() - t0:.1f} s)", flush=True)
        for key in ("detect", "topk", "scan"):
            out[f"{name}_{key}_rows"] = np.concatenate(rec[key])
            out[f"{name}_{key}_counts"] = np.asarray(
                [len(r) for r in rec[key]], np.int32)
        for key in ("n_weak", "n_loc", "scan_n_weak"):
            out[f"{name}_{key}"] = np.asarray(rec[key], np.int64)
    multi = []
    for i, img in enumerate(frames):
        t0 = time.time()
        boxes = wb.detect(img, *models.values(),
                          response_scale=list(RESPONSE_SCALE))
        multi.append(_rows(boxes, "scores", "label"))
        print(f"wb.detect frame {i}: {len(boxes)} boxes "
              f"({time.time() - t0:.1f} s)", flush=True)
    out["multi_rows"] = np.concatenate(multi)
    out["multi_counts"] = np.asarray([len(r) for r in multi], np.int32)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
