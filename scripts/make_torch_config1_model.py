"""Write BASELINE config 1's synthetic stump cascade as a model file.

Builds the model exactly as ``bench.py::bench_vga_single_scale`` does, with
the JAX package on the CPU: ``__graft_entry__._flagship_model(n_stages=64,
depth=1)`` (64 stumps over grad_hist, 12x12x4 window, shrink 2, n_per_oct
8, smooth 1, thresholds from seeded channel samples, thetas from the
survivor-quantile calibration), and saves it as
``models/config1_stump_synth_64.pb``, so the PyTorch port serves config 1
(VGA, one pyramid scale: ``make_batched_detector_boxes(n_scales=1)``)
without jax.

Usage (from the repository root; a few seconds on one CPU):

    python scripts/make_torch_config1_model.py
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "config1_stump_synth_64"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "models"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _flagship_model

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    model = _flagship_model(n_stages=64, depth=1)
    path = os.path.join(args.out_dir, NAME + ".pb")
    model.save(path)
    print(f"wrote {path}: {len(model)} stages, channels "
          f"{model.channel_opts['channels'].name} ({time.time() - t0:.1f} s)",
          flush=True)


if __name__ == "__main__":
    main()
