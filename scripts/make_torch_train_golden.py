"""Write the training goldens the PyTorch port is held against, made by
the JAX package's training loops on the CPU, in-repo, with nothing to
download.

* ``tests/data/torch_port_train_golden.npz``: BASELINE config 4 (the
  host-pool training loop), ``wb.train`` of ``Model((12, 12, 4), shrink 2,
  n_per_oct 4, smooth 1, grad_hist)`` on ``fake_data_generator(seed=11)``,
  ``SamplePool(min_tp=1000, min_fp=1000, seed=0)``, ``Learner(alpha=0.2,
  max_depth=2)`` and the default rejection schedule (``chip_smoke.py``'s
  ``TRAIN_*`` settings), ``--stages`` stages (6);
* ``tests/data/torch_port_fpga_train_golden.npz``: ``fpga.train`` of
  ``Model((8, 8, 4), shrink 2, n_per_oct 2, smooth 1, grad_hist_4_u1)`` on
  ``fake_data_generator(seed=3)``, ``SamplePool(min_tp=60, min_fp=60,
  seed=0)``, depth 2 and the trainer's defaults (``FPGA_TRAIN_*``),
  ``--fpga-stages`` stages (2).

A callback saves, per stage ``s`` (after the stage's fit; the pool is the
one the fit saw):

* ``s{s}_labels`` (int8), ``s{s}_scores`` (float32), ``s{s}_instance_id``
  (int32): the pool in pool order, and ``digest[s]``, the SHA-256 of its
  samples (``chip_smoke.py::samples_digest``: float32 bytes, values below
  2**-30 in magnitude as 0; the samples themselves are not saved);
* ``n_tp[s]``, ``n_fp[s]``, and the model's counters ``n_weak[s]``,
  ``n_loc[s]``, ``n_images[s]``;
* the tree ``s{s}_feature`` ((k, 3) int32, leaves (0, 0, 0)),
  ``s{s}_threshold``, ``s{s}_left``, ``s{s}_right``, ``s{s}_prediction``,
  the float64 ``theta[s]`` and the learner's ``p0[s]``, ``p1[s]``,
  ``loss[s]``.

Usage (from the repository root; about a minute on a CPU):

    python scripts/make_torch_train_golden.py
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (FPGA_TRAIN_DEPTH, FPGA_TRAIN_GOLDEN,  # noqa: E402
                        FPGA_TRAIN_OPTS, FPGA_TRAIN_POOL, FPGA_TRAIN_SEED,
                        FPGA_TRAIN_SHAPE, TRAIN_ALPHA, TRAIN_DEPTH,
                        TRAIN_GOLDEN, TRAIN_OPTS, TRAIN_POOL, TRAIN_SEED,
                        TRAIN_SHAPE, samples_digest)


def recorder(out, pool, t0):
    """A training callback that adds stage ``s`` to ``out``."""
    def record(model, learner, s):
        box = pool.samples
        out[f"s{s}_labels"] = box.get_field("tp_label").astype(np.int8)
        out[f"s{s}_scores"] = box.get_field("scores").astype(np.float32)
        out[f"s{s}_instance_id"] = box.get_field("instance_id").astype(
            np.int32)
        out["digest"].append(samples_digest(box.get_field("samples")))
        st = pool.pool_stats()
        out["n_tp"].append(st["num_tp"])
        out["n_fp"].append(st["num_fp"])
        cost = model.cost_stats()
        for k in ("n_weak", "n_loc", "n_images"):
            out[k].append(cost[k])
        for k, v in model.classifier[-1].to_stage_dict().items():
            out[f"s{s}_{k}"] = np.asarray(v)
        out["theta"].append(model.theta[-1])
        rec = learner.history[-1]
        out["p0"].append(rec.p0)
        out["p1"].append(rec.p1)
        out["loss"].append(rec.loss)
        print(f"stage {s}: pool tp {st['num_tp']} fp {st['num_fp']}, theta "
              f"{model.theta[-1]!r}, p0 {rec.p0:.4f} p1 {rec.p1:.4f} "
              f"({time.time() - t0:.1f} s)", flush=True)
    return record


def write(out, path):
    arrays = {k: np.asarray(v) for k, v in out.items()}
    arrays["theta"] = arrays["theta"].astype(np.float64)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", type=int, default=6)
    ap.add_argument("--fpga-stages", type=int, default=2)
    ap.add_argument("--out", default=TRAIN_GOLDEN)
    ap.add_argument("--fpga-out", default=FPGA_TRAIN_GOLDEN)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import waldboost_tpu as wb
    from waldboost_tpu.fpga import training as fpga_training
    from waldboost_tpu.utils import fake_data_generator

    def empty():
        return {k: [] for k in ("n_tp", "n_fp", "n_weak", "n_loc",
                                "n_images", "digest", "theta", "p0", "p1",
                                "loss")}

    t0 = time.time()
    out, pool = empty(), wb.SamplePool(min_tp=TRAIN_POOL, min_fp=TRAIN_POOL,
                                       seed=0)
    wb.train(wb.Model(TRAIN_SHAPE, TRAIN_OPTS),
             fake_data_generator(seed=TRAIN_SEED), pool=pool,
             learner=wb.Learner(alpha=TRAIN_ALPHA, max_depth=TRAIN_DEPTH),
             length=args.stages, callbacks=[recorder(out, pool, t0)])
    write(out, args.out)

    out, pool = empty(), wb.SamplePool(min_tp=FPGA_TRAIN_POOL,
                                       min_fp=FPGA_TRAIN_POOL, seed=0)
    fpga_training.train(wb.Model(FPGA_TRAIN_SHAPE, FPGA_TRAIN_OPTS),
                        fake_data_generator(seed=FPGA_TRAIN_SEED), pool=pool,
                        length=args.fpga_stages, max_depth=FPGA_TRAIN_DEPTH,
                        callbacks=[recorder(out, pool, t0)])
    write(out, args.fpga_out)


if __name__ == "__main__":
    main()
