"""The harness on the CPU: a cell added as files alone, the window's
arithmetic, and the faults that have to make ``correct`` false."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from wbbench import control, harness

ROOT = harness.ROOT


def _tiny(tmp_path, chips=1, name="tiny_scenes", config="flagship_vga"):
    """A configuration, a traffic file and a benchmark entry written
    here, none of them in the repository."""
    (tmp_path / "wbbench" / "configs").mkdir(parents=True)
    (tmp_path / "wbbench" / "workloads").mkdir(parents=True)
    cfg = json.load(open(os.path.join(ROOT, "wbbench", "configs",
                                      config + ".json")))
    cfg.update(model=os.path.join(ROOT, cfg["model"]), frame_hw=[240, 320],
               frames_per_chip=2, k=64)
    (tmp_path / "wbbench" / "configs" / "tiny.json").write_text(
        json.dumps(cfg))
    (tmp_path / "wbbench" / "workloads" / f"{name}.json").write_text(
        json.dumps({"frames": "scenes",
                    "pool_frames": 4 * chips, "trace_calls": 3}))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "tiny",
                             "file": "wbbench/configs/tiny.json"})
    bench["workloads"].append({"name": name, "config": "tiny",
                               "traffic": name, "chips": chips})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench


def _run(tmp_path, traced=False, chips=1, wrap=None, seconds=0.3,
         config="flagship_vga"):
    bench = _tiny(tmp_path, chips, config=config)
    if wrap == "control":
        wrap = control.wrap("tiny_scenes", "cpu", bench, str(tmp_path))
    return harness.run_cell("tiny_scenes", 2**33 + 5, seconds, traced,
                            ["cpu"] * chips, time.perf_counter(),
                            bench=bench, root=str(tmp_path), wrap=wrap,
                            log=lambda msg: None)


def test_window_stats_take_every_call_and_all_the_time():
    times = [0.01] * 99 + [0.5]   # one stall
    st = harness.window_stats(times, window_s=1.49, pixels_per_call=10**6)
    assert st["mpix_s"] == pytest.approx(100 / 1.49)
    assert st["batch_p50_ms"] == pytest.approx(10.0)
    base = harness.window_stats([0.01] * 100, 1.0, 10**6)
    # the stall moves the rate and the tail, not the median
    assert st["mpix_s"] < base["mpix_s"]
    assert st["batch_p95_ms"] == pytest.approx(np.percentile(times, 95)
                                               * 1e3)
    stalls = harness.window_stats([0.01] * 90 + [0.5] * 10, 5.9, 10**6)
    assert stalls["batch_p95_ms"] == pytest.approx(500.0)


def test_a_cell_added_as_files_runs_and_is_correct(tmp_path):
    r = _run(tmp_path)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"mpix_s", "batch_p95_ms",
                                 "batch_p50_ms", "setup_s"}
    assert r["checks"]["mismatched_values"]["value"] == 0
    assert list(r)[-1] == "checks"


def test_a_traced_run_reads_the_per_layer_metrics(tmp_path):
    r = _run(tmp_path, traced=True)
    assert r["correct"]
    # on the CPU no device metric is read, and none reads 0 in its place
    assert "canvas.host_ms" in r["metrics"]
    assert "nms.host_ms" in r["metrics"]
    for name in ("canvas.device_ms", "cascade.device_ms",
                 "cascade_roofline", "device.idle_share"):
        assert name not in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_a_metric_added_as_a_file_reads_the_walk_of_each_call(tmp_path):
    bench = _tiny(tmp_path)
    (tmp_path / "wbbench" / "metrics").mkdir()
    (tmp_path / "wbbench" / "metrics" / "tiny.node_evals.py").write_text(
        "def read(ctx):\n"
        "    return sum(s['node_evals'] for s in ctx['runs']) / "
        "len(ctx['runs'])\n")
    bench["per_layer"].append({"name": "tiny.node_evals", "unit": "1",
                               "better": "lower", "source": "device_trace",
                               "layer": "cascade", "moves": "mpix_s"})
    r = harness.run_cell("tiny_scenes", 2**33 + 5, 0.3, True, ["cpu"],
                         time.perf_counter(), bench=bench,
                         root=str(tmp_path), log=lambda msg: None)
    assert r["metrics"]["tiny.node_evals"]["value"] > 0


def _altered(det):
    def fn(x):
        outs = list(det(x))
        outs[0] = outs[0].clone()
        # one box coordinate, where produced: an empty slot's zero box too,
        # so the fault shows whether or not the frame has detections
        outs[0][0, 0, 0] = outs[0][0, 0, 0] + 1.0
        return tuple(outs)
    return fn


def _half_batch(det):
    def fn(x):
        h = x.shape[0] // 2
        outs = det(x[:h])
        return tuple(torch.cat([o, o]) for o in outs)
    return fn


def _stale(det):
    state = {}

    def fn(x):
        outs = det(x)
        prev = state.get("prev", outs)
        state["prev"] = outs
        return prev
    return fn


def _no_exchange(det):
    def fn(x):
        outs = det(x)   # lists of shards
        return tuple([o[0]] * len(o) for o in outs)
    return fn


@pytest.mark.parametrize("fault,chips", [(_altered, 1), (_half_batch, 1),
                                         (_stale, 1), (_no_exchange, 2)])
def test_a_fault_makes_the_run_incorrect(tmp_path, fault, chips):
    r = _run(tmp_path, chips=chips, wrap=fault)
    assert not r["correct"]
    assert r["checks"]["mismatched_values"]["value"] > 0
    assert r["failed"] > 0


@pytest.mark.parametrize("config,chips", [("flagship_vga", 1),
                                          ("fpga_4k", 1),
                                          ("flagship_vga", 2)])
def test_the_control_in_the_programs_place_is_incorrect(tmp_path, config,
                                                        chips):
    r = _run(tmp_path, chips=chips, wrap="control", config=config)
    assert not r["correct"]
    assert r["checks"]["mismatched_values"]["value"] > 0


CELLS = [c["name"] for c in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**33 + 101, 2**33 + 102, 2**33 + 103])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_each_cells_size_is_incorrect(cell, seed):
    """The upper reading: the control run as the cell's window runs,
    at its own size; one JSON line with the readings."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    chips = harness.load_cell(cell)["cell"]["chips"]
    if chips > torch.cuda.device_count():
        pytest.skip(f"{cell} needs {chips} GPUs")
    devices = [f"cuda:{i}" for i in range(chips)]
    r = harness.run_cell(cell, seed, 15.0, False, devices,
                         time.perf_counter(), log=lambda msg: None,
                         wrap=control.wrap(cell, devices[0]))
    print(json.dumps({"control": cell, "seed": seed,
                      "attempted": r["attempted"], "checks": r["checks"]}),
          flush=True)
    assert not r["correct"]


def test_sound_mesh_run_is_correct(tmp_path):
    assert _run(tmp_path, chips=2)["correct"]


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["waldboost_tpu_torch", "waldboost_tpu_torch.ops", "jaxtyping",
            "flaxen", "waldboost_tpu", "waldboost_tpu.ops.nms", "jax",
            "jaxlib.xla", "flax.linen"]
    assert harness.forbidden_modules(mods) == sorted(
        ["waldboost_tpu", "waldboost_tpu.ops.nms", "jax", "jaxlib.xla",
         "flax.linen"])


def test_run_needs_a_card_and_prints_no_result_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    p = subprocess.run([sys.executable, "wbbench/run.py", "--workload",
                        "vga_scenes", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_each_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cell in bench["workloads"]:
        if cell["chips"] > torch.cuda.device_count():
            continue
        p = subprocess.run([sys.executable, "wbbench/run.py", "--workload",
                            cell["name"], "--seed", str(2**33 + 1),
                            "--seconds", "2", "--trace", "0"], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
