"""Run one cell of the benchmark once and print its result line.

    python3 wbbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic and its metrics come from
``BENCHMARK.json`` and the files it names.  With ``--trace 0`` the last
line of standard output is the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a torch.profiler trace of the
window; every run checks the outputs of the timed path against the plain
reference and prints the numbers compared, with their limits, as the
last lines of standard error and under ``checks`` in the result line.
The run needs as many CUDA devices as the cell has chips and exits 2
without a result when they are not there; it exits 3 without a result
when a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".wbbench_cache")


def _environment() -> None:
    # the loop is a single host thread; which cores it runs on is left to
    # the caller (``taskset``)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from wbbench import harness
    spec = harness.load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA devices, found {n}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        [f"cuda:{i}" for i in range(chips)], T_START, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for key, c in result["checks"].items():
        log(f"check {key} {c['value']} must be {c['must_be']} "
            f"{c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
