"""Write the golden of the PyTorch port's multi-process mesh program, made
by the JAX package on the CPU, in-repo, with nothing to download.

It runs JAX's ``tests/mp_worker.py::run_program`` in one process over
``make_mesh(8)`` (8 virtual CPU devices): an 8-stage ``wb.train`` with the
device pool sharded over the mesh, then a sharded
``make_batched_detector_boxes(k=64, nms_iou=0.5)`` of 8 seeded 48 x 64
frames.  The JAX package is not edited: ``wb.train`` and the trainer's
``make_train_step`` are wrapped from outside to keep the model and each
stage's heap tree.  ``tests/data/torch_port_mesh_golden.npz`` holds

* ``s{s}_heap_feature``, ``_threshold``, ``_left``, ``_right``, ``_pred``:
  the heap tree of stage ``s`` (the teacher-forced fits of
  ``tests/torch_mp_worker.py``);
* ``feature{t}``, ``threshold{t}``, ``left{t}``, ``right{t}``,
  ``prediction{t}``: the model's stage dicts (``DTree.to_stage_dict``);
* ``theta`` and ``losses`` (float64), and the detection outputs
  ``rects``, ``scores``, ``valid``, ``count`` over the 8 frames (the
  trained model keeps none of them);
* ``scene_rects``, ``scene_scores``, ``scene_valid``, ``scene_count``:
  the same detector (``k=1024``) without NMS over the 8 frames (256 x
  256) of ``fake_data_generator(seed=6)``, sharded over the same mesh,
  on which it keeps windows (``tests/torch_mp_worker.py::scene_frames``):
  the candidates in extraction order, which the port's NMS is held to
  through the host NMS (JAX's device NMS may round a pair at IoU exactly
  1/2 the other way).

Usage (from the repository root; about 30 s on a CPU):

    python scripts/make_torch_mesh_golden.py
"""

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_mesh_golden.npz")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import waldboost_tpu as wb
    from mp_worker import run_program
    from waldboost_tpu.parallel import trainer as jtrainer
    from waldboost_tpu.parallel.mesh import make_mesh

    trees, models = [], []
    real_make, real_train = jtrainer.make_train_step, wb.train

    def recording_make(**kwargs):
        step = real_make(**kwargs)

        def rec(*a):
            res = step(*a)
            trees.append([np.asarray(x) for x in res.tree])
            return res
        return rec

    def recording_train(model, *a, **kw):
        models.append(model)
        return real_train(model, *a, **kw)

    jtrainer.make_train_step, wb.train = recording_make, recording_train
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sp.npz")
            run_program(make_mesh(8), path)
            sp = dict(np.load(path))
    finally:
        jtrainer.make_train_step, wb.train = real_make, real_train
    (model,) = models
    assert len(trees) == len(model) == 8
    out = {k: sp[k] for k in ("theta", "losses", "rects", "scores", "valid",
                              "count")}
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes
    from waldboost_tpu.parallel.mesh import shard_array
    from waldboost_tpu.utils import fake_data_generator
    it = fake_data_generator(seed=6)
    scene = np.stack([next(it)["image"] for _ in range(8)])
    mesh = make_mesh(8)
    fn, _ = make_batched_detector_boxes(model, scene.shape[1:], mesh=mesh,
                                        k=1024)
    for k, a in zip(("rects", "scores", "valid", "count"),
                    fn(shard_array(scene, mesh))):
        out[f"scene_{k}"] = np.asarray(a)
    for s, tree in enumerate(trees):
        for k, a in zip(("feature", "threshold", "left", "right", "pred"),
                        tree):
            out[f"s{s}_heap_{k}"] = a
    for t, weak in enumerate(model.classifier):
        for k, a in weak.to_stage_dict().items():
            out[f"{k}{t}"] = np.asarray(a)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {len(model)} stages, scene counts "
          f"{out['scene_count'].tolist()}, kept "
          f"{out['scene_valid'].sum(1).tolist()}")


if __name__ == "__main__":
    main()
