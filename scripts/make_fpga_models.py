"""Write the two synthetic BASELINE config-5 cascades as model files.

Builds each model exactly as ``bench.py::bench_fpga_4k`` does, with the
JAX package on the CPU: ``__graft_entry__._flagship_model`` with
``channel_opts=dict(shrink=2, n_per_oct=4, smooth=s,
channels="grad_hist_4_u1+grad_mag_u1")``, ``image_hw=(540, 960)`` and
``shape=(12, 12, 5)`` (64 depth-2 stages, thresholds from seeded channel
samples, thetas from the survivor-quantile calibration), and saves

* ``models/fpga_4k_synth_64.pb`` (``smooth=0``),
* ``models/fpga_4k_smooth_synth_64.pb`` (``smooth=1``),

so the PyTorch port and a port benchmark load the same cascades without
jax.

Usage (from the repository root; about a minute on one CPU):

    python scripts/make_fpga_models.py
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = (("fpga_4k_synth_64", 0), ("fpga_4k_smooth_synth_64", 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "models"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _flagship_model

    os.makedirs(args.out_dir, exist_ok=True)
    for name, smooth in MODELS:
        t0 = time.time()
        opts = dict(shrink=2, n_per_oct=4, smooth=smooth,
                    channels="grad_hist_4_u1+grad_mag_u1")
        model = _flagship_model(channel_opts=opts, image_hw=(540, 960),
                                shape=(12, 12, 5))
        path = os.path.join(args.out_dir, name + ".pb")
        model.save(path)
        print(f"wrote {path}: {len(model)} stages, channels "
              f"{model.channel_opts['channels'].name} ({time.time() - t0:.1f}"
              f" s)", flush=True)


if __name__ == "__main__":
    main()
