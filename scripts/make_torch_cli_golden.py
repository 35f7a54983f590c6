"""Write the golden of the PyTorch port's verifier training, CLI and
single-scale serving, made by the JAX package on the CPU, in-repo, with
nothing to download: ``tests/data/torch_port_cli_golden.npz``
(``chip_smoke.py``'s ``CLI_GOLDEN``; its phases 7a, 7c, 7d and 7e).

It stores no pools or frames: each side rebuilds them from their seeds
(``chip_smoke.py::verifier_pools``, ``write_cli_frames``,
``n_scales_frames``).

* ``vinit/...``: ``verification.init_verifier((12, 12, 4), seed=0)``'s
  flax parameters, one key a leaf (``vinit/params/Conv_0/kernel``, ...);
* ``vfinal/...`` and ``vtrain_log``: the parameters after
  ``verification.train`` from that init on ``verifier_pools()`` with
  ``VTRAIN_KW`` (2 epochs of 50 batches of 64, lr 1e-4, seed 0) through
  a wrapper whose ``apply`` forces ``deterministic=True`` (dropout off;
  nothing in the JAX package changes), and the lines it printed;
* ``train_model``/``train_json`` and ``fpga_model``/``fpga_json``: the
  bytes of the model file ``cli.train_main`` wrote and the JSON line it
  printed, at ``CLI_TRAIN_RUNS``' ``CLI_TRAIN_ARGS`` and ``CLI_FPGA_ARGS``;
* ``detect_json_1``/``detect_json_2``: ``cli.detect_main``'s output over
  the ``CLI_FRAMES`` VGA scenes with ``CLI_DETECT_MODELS``' first model
  and with both;
* ``ns/<model>/<n_scales>/<n_weak|plain>/<frames>/{count,n_weak,kept,
  rows}`` (``chip_smoke.py::n_scales_key``): per ``N_SCALES_RUNS`` entry
  and ``n_scales_frames`` batch, ``parallel.detect.
  make_batched_detector_boxes(n_scales=...)``'s counts and n_weak, the
  number of valid boxes per frame and their (x1, y1, x2, y2, score) rows
  in extraction order.

Usage (from the repository root; about 75 s on a CPU):

    python scripts/make_torch_cli_golden.py
"""

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (CLI_GOLDEN, CLI_TRAIN_RUNS,  # noqa: E402
                        N_SCALES_RUNS, TRAIN_SHAPE, VGA, VTRAIN_KW,
                        cli_detect_args, cli_output, n_scales_frames,
                        n_scales_key, verifier_pools, write_cli_frames)


class Deterministic:
    """A flax module whose ``apply`` always runs with dropout off."""

    def __init__(self, module):
        self.module = module

    def apply(self, params, x, deterministic=True, rngs=None):
        return self.module.apply(params, x, deterministic=True)


def flatten(tree, prefix):
    """``{prefix/a/b: leaf}`` of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=CLI_GOLDEN)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import waldboost_tpu as wb
    from waldboost_tpu import cli
    from waldboost_tpu import verification as V
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    out = {}
    t0 = time.time()
    module, params = V.init_verifier(TRAIN_SHAPE, seed=0)
    out.update(flatten(params, "vinit"))
    X0, H0, X1, H1 = verifier_pools()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        final = V.train(Deterministic(module), params, X0, H0, X1, H1,
                        **VTRAIN_KW)
    out.update(flatten(final, "vfinal"))
    out["vtrain_log"] = np.array(log.getvalue())
    print(f"verifier training: {log.getvalue().strip()!r} "
          f"({time.time() - t0:.1f} s)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        for key, argv in CLI_TRAIN_RUNS.items():
            t0 = time.time()
            path = os.path.join(tmp, key + ".pb")
            line = cli_output(cli.train_main, ("-o", path) + argv)
            with open(path, "rb") as f:
                out[key + "_model"] = np.frombuffer(f.read(), np.uint8)
            out[key + "_json"] = np.array(line.strip().splitlines()[-1])
            print(f"CLI train {key}: {out[key + '_json']} "
                  f"({time.time() - t0:.1f} s)", flush=True)
        paths = write_cli_frames(tmp)
        for n_models in (1, 2):
            t0 = time.time()
            argv = cli_detect_args(n_models, paths)
            out[f"detect_json_{n_models}"] = np.array(
                cli_output(cli.detect_main, argv))
            print(f"CLI detect, {n_models} model(s) ({time.time() - t0:.1f} "
                  f"s)", flush=True)

    frames = n_scales_frames()
    for name, ns, k, with_n_weak in N_SCALES_RUNS:
        t0 = time.time()
        model = wb.Model.load(os.path.join(ROOT, "models", name + ".pb"))
        fn, _ = make_batched_detector_boxes(model, VGA, k=k,
                                            with_n_weak=with_n_weak,
                                            n_scales=ns)
        for fname, batch in frames:
            key = n_scales_key(name, ns, with_n_weak, fname)
            rects, scores, valid, count, n_weak = (
                np.asarray(a) for a in fn(jnp.asarray(batch)))
            out[key + "/count"] = count.astype(np.int32)
            out[key + "/n_weak"] = n_weak.astype(np.int32)
            out[key + "/kept"] = valid.sum(1).astype(np.int32)
            out[key + "/rows"] = np.concatenate(
                [np.concatenate([rects[b][valid[b]],
                                 scores[b][valid[b]][:, None]], axis=1)
                 for b in range(len(batch))]).astype(np.float32)
            print(f"{key}: counts {count.tolist()} "
                  f"({time.time() - t0:.1f} s)", flush=True)

    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
