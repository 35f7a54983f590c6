"""Write the goldens of the device-pool trainer the PyTorch port is held
against, made by the JAX package on the CPU, in-repo, with nothing to
download.

``tests/data/torch_port_device_train_golden.npz`` (BASELINE config 4b):
``parallel.trainer.train_sharded`` (``mesh=None``) of ``Model((12, 12,
4), shrink 2, n_per_oct 4, smooth 1, grad_hist)`` on ``prefetch_iterable(
fake_data_generator(seed=11), depth=32)`` with ``Learner(alpha=0.2,
max_depth=2)``, ``min_tp=min_fp=1000`` and mining seed 0: a warm call to
length 2, then one to ``--stages`` (6), sharing one ``pools`` dict, as
``bench.py::bench_train_loop_device_pool`` runs it (``chip_smoke.py``'s
``DEVICE_TRAIN_*`` and ``TRAIN_*`` settings).

``tests/data/torch_port_device_fpga_train_golden.npz``: the same trainer
with the FPGA options in-step at ``chip_smoke.py``'s ``FPGA_TRAIN_*``
model, data and quotas (``DEVICE_FPGA_TRAIN_KW``: clip 3, quantizer 32,
integer thresholds; ``bank_masks_fn``'s masks from ``PixelBanks`` (2 x 2)
and ``BankScheduler``), one call to ``--fpga-stages`` (2).

The JAX package is not edited: the trainer module's ``make_train_step``
is wrapped from outside, and the wrapper saves, per stage ``s`` (the
``s``-th step call):

* the pools entering the step: ``s{s}_v0``/``s{s}_v1`` (bool) and
  ``s{s}_H0``/``s{s}_H1`` (float32) over every slot, ``n_fp[s]`` and
  ``n_tp[s]`` (``sum(v)``), ``digest_fp[s]``/``digest_tp[s]``, the SHA-256
  of the whole padded ``x`` (``chip_smoke.py::samples_digest``: values
  below 2**-30 in magnitude as 0), and the model's counters ``n_weak[s]``,
  ``n_loc[s]``, ``n_images[s]``;
* the step's inputs ``P0[s]``, ``P1[s]``, ``use_sprt[s]``,
  ``theta_in[s]`` (float32) and the feature mask ``s{s}_fmask`` where
  it restricts the fit (JAX passes an all-true mask otherwise);
* its outputs: the heap tree ``s{s}_heap_feature``, ``_heap_threshold``,
  ``_heap_left``, ``_heap_right``, ``_heap_pred``; ``theta[s]``,
  ``p0[s]``, ``p1[s]``, ``loss[s]`` (float32), ``n0[s]``, ``n1[s]`` and
  the pruned masks ``s{s}_v0_out``/``s{s}_v1_out``;
* with the FPGA options, the fitted tree before their transforms,
  ``s{s}_fit_*``: the same step without them, on the same inputs (the
  script checks that the transforms take it to ``s{s}_heap_*``);

and a callback saves the pruned tree the model appended (``s{s}_feature``
((k, 3) int32, leaves (0, 0, 0)), ``s{s}_threshold``, ``s{s}_left``,
``s{s}_right``, ``s{s}_prediction``).

Usage (from the repository root; about 30 s on a CPU):

    python scripts/make_torch_device_train_golden.py
    python scripts/make_torch_device_train_golden.py --runs fpga
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (DEVICE_FPGA_TRAIN_GOLDEN,  # noqa: E402
                        DEVICE_FPGA_TRAIN_KW, DEVICE_TRAIN_GOLDEN,
                        DEVICE_TRAIN_PREFETCH, DEVICE_TRAIN_SEED,
                        DEVICE_TRAIN_WARM, FPGA_TRAIN_DEPTH, FPGA_TRAIN_OPTS,
                        FPGA_TRAIN_SEED, FPGA_TRAIN_SHAPE, TRAIN_ALPHA,
                        TRAIN_DEPTH, TRAIN_OPTS, TRAIN_POOL, TRAIN_SEED,
                        TRAIN_SHAPE, bank_masks_fn, samples_digest)

LISTS = ("n_fp", "n_tp", "digest_fp", "digest_tp", "n_weak", "n_loc",
         "n_images", "P0", "P1", "use_sprt", "theta_in", "theta", "p0", "p1",
         "loss", "n0", "n1")
FPGA_OPTIONS = ("clip", "quantizer", "integer_thresholds")


def record(run, n_stages, out_path):
    """Run JAX's train_sharded for ``run`` ("4b" or "fpga") with its step
    wrapped, and write the golden to ``out_path``."""
    import waldboost_tpu as wb
    from waldboost_tpu.fpga.banks import BankScheduler, PixelBanks
    from waldboost_tpu.io import prefetch_iterable
    from waldboost_tpu.parallel import trainer
    from waldboost_tpu.utils import fake_data_generator

    out = {k: [] for k in LISTS}
    if run == "fpga":
        model = wb.Model(FPGA_TRAIN_SHAPE, FPGA_TRAIN_OPTS)
        gen = fake_data_generator(seed=FPGA_TRAIN_SEED)
        banks = PixelBanks(FPGA_TRAIN_SHAPE, (2, 2))
        kw = dict(DEVICE_FPGA_TRAIN_KW, feature_masks_fn=bank_masks_fn(
            banks, BankScheduler(int(banks.n_banks)), []))
        depth, lengths = FPGA_TRAIN_DEPTH, (n_stages,)
    else:
        model = wb.Model(TRAIN_SHAPE, TRAIN_OPTS)
        gen = prefetch_iterable(fake_data_generator(seed=TRAIN_SEED),
                                depth=DEVICE_TRAIN_PREFETCH)
        kw = dict(min_tp=TRAIN_POOL, min_fp=TRAIN_POOL,
                  seed=DEVICE_TRAIN_SEED, pools={})
        depth, lengths = TRAIN_DEPTH, (DEVICE_TRAIN_WARM, n_stages)
    t0 = time.time()
    real_make = trainer.make_train_step

    def make(**kwargs):
        step = real_make(**kwargs)
        fpga = any(kwargs.get(k) for k in FPGA_OPTIONS)
        raw_step = real_make(**dict(kwargs, clip=None, quantizer=None,
                                    integer_thresholds=False))

        def recorded(x0, H0, v0, x1, H1, v1, P0, P1, theta_in, use_sprt,
                     fmask=None):
            s = len(out["theta"])
            for name, a in (("v0", v0), ("v1", v1), ("H0", H0), ("H1", H1)):
                out[f"s{s}_{name}"] = np.array(a)
            out["n_fp"].append(int(np.sum(v0)))
            out["n_tp"].append(int(np.sum(v1)))
            out["digest_fp"].append(samples_digest(np.asarray(x0)))
            out["digest_tp"].append(samples_digest(np.asarray(x1)))
            cost = model.cost_stats()
            for k in ("n_weak", "n_loc", "n_images"):
                out[k].append(cost[k])
            for k, v in (("P0", P0), ("P1", P1), ("use_sprt", use_sprt),
                         ("theta_in", theta_in)):
                out[k].append(np.asarray(v).item())
            if fmask is not None and not np.all(fmask):
                out[f"s{s}_fmask"] = np.array(fmask, bool)
            args = (x0, H0, v0, x1, H1, v1, P0, P1, theta_in, use_sprt, fmask)
            res = step(*args)
            for k, v in res.tree._asdict().items():
                out[f"s{s}_heap_{k}"] = np.array(v)
            if fpga:
                fit = {k: np.array(v) for k, v in
                       raw_step(*args).tree._asdict().items()}
                q = np.float32(kwargs["quantizer"])
                clip = np.float32(kwargs["clip"])
                want = dict(fit, threshold=np.floor(fit["threshold"]),
                            pred=np.round(q * np.clip(
                                fit["pred"], -clip, clip)) / q)
                assert all(np.array_equal(want[k], out[f"s{s}_heap_{k}"])
                           for k in want), \
                    f"stage {s}: the FPGA transforms of the plain fit are " \
                    f"not the step's tree"
                for k, v in fit.items():
                    out[f"s{s}_fit_{k}"] = v
            for k in ("theta", "p0", "p1", "loss", "n0", "n1"):
                out[k].append(np.asarray(getattr(res, k)).item())
            out[f"s{s}_v0_out"] = np.array(res.v0)
            out[f"s{s}_v1_out"] = np.array(res.v1)
            print(f"{run} stage {s}: pools fp {out['n_fp'][-1]} tp "
                  f"{out['n_tp'][-1]}, theta {out['theta'][-1]!r}, p0 "
                  f"{out['p0'][-1]:.4f} p1 {out['p1'][-1]:.4f} "
                  f"({time.time() - t0:.1f} s)", flush=True)
            return res
        return recorded

    def keep_tree(model_, learner, s):
        for k, v in model_.classifier[-1].to_stage_dict().items():
            out[f"s{s}_{k}"] = np.asarray(v)

    trainer.make_train_step = make
    try:
        learner = wb.Learner(alpha=TRAIN_ALPHA, max_depth=depth)
        for length in lengths:
            trainer.train_sharded(model, gen, mesh=None, learner=learner,
                                  length=length, callbacks=[keep_tree], **kw)
    finally:
        trainer.make_train_step = real_make

    arrays = {k: np.asarray(v) for k, v in out.items()}
    for k in ("P0", "P1", "theta_in", "theta", "p0", "p1", "loss"):
        arrays[k] = arrays[k].astype(np.float32)
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default="4b,fpga",
                    help="comma-separated: 4b, fpga")
    ap.add_argument("--stages", type=int, default=6,
                    help="config 4b's stages")
    ap.add_argument("--fpga-stages", type=int, default=2)
    ap.add_argument("--out-dir", default=os.path.dirname(DEVICE_TRAIN_GOLDEN),
                    help="where the golden files go")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    for run in args.runs.split(","):
        n, path = {"4b": (args.stages, DEVICE_TRAIN_GOLDEN),
                   "fpga": (args.fpga_stages,
                            DEVICE_FPGA_TRAIN_GOLDEN)}[run]
        record(run, n, os.path.join(args.out_dir, os.path.basename(path)))


if __name__ == "__main__":
    main()
