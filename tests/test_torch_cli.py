"""PyTorch port, the command-line tools on the CPU
(``waldboost_tpu_torch/cli.py`` with ``--device cpu``), held against the
JAX package's ``waldboost_tpu/cli.py`` on the same arguments and files,
live or through the committed golden its script made
(``tests/data/torch_port_cli_golden.npz``,
``scripts/make_torch_cli_golden.py``: chip_smoke.py's phases 7c and 7d,
replayed here on the CPU).

Tolerances: a trained model's stage count, tree structure, features and
thresholds bitwise, its predictions and thetas within 1e-5 (numpy's and
XLA's ``log`` round apart; the thetas follow the predictions); the JSON
line equal but for the loss, within 1e-6.  detect_main's JSON with one
model equal; with several, each file's (box, score, label) rows equal as
sets (JAX orders them by its two-phase compaction, which the port does
not have).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu import cli as jcli

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import cli as tcli
from waldboost_tpu_torch.utils import scene_generator

from test_cli import _write_bbgt_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (CLI_GOLDEN, check_cli_model,  # noqa: E402
                        check_cli_stats, cli_detect_args,
                        cli_detect_golden_run, cli_json, cli_output,
                        cli_rows, cli_train_golden_run, write_cli_frames)

torch.set_num_threads(2)

CPU = ("--device", "cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(CLI_GOLDEN)


def test_train_main_matches_jax(tmp_path):
    """train_main on the synthetic stream, 3 stages at pools of 60: the
    saved model and the JSON line against JAX's train_main."""
    args = ("--length", "3", "--n-per-oct", "2", "--min-tp", "60",
            "--min-fp", "60", "--seed", "0")
    jpath, tpath = str(tmp_path / "jax.pb"), str(tmp_path / "port.pb")
    want = cli_output(jcli.train_main, ("-o", jpath) + args)
    got = cli_output(tcli.train_main, ("-o", tpath) + args + CPU)
    assert check_cli_stats(got, want.strip().splitlines()[-1],
                           "train_main") == 3
    with open(jpath, "rb") as f:
        check_cli_model(wt, tpath, np.frombuffer(f.read(), np.uint8),
                        "train_main")
    assert json.loads(got.strip().splitlines()[-1])["model"] == tpath
    assert len(wb.Model.load(tpath)) == 3  # JAX loads the port's file


@pytest.mark.parametrize("key", ["train", "fpga"])
def test_train_main_golden_on_cpu(golden, tmp_path, key):
    """chip_smoke.py phase 7c on the CPU: config 4's widths (4 stages,
    pools of 1000) and --fpga (3 stages, grad_hist_4_u1) against JAX's
    CLI models and JSON lines in the golden."""
    assert cli_train_golden_run(wt, torch.device("cpu"), golden,
                                str(tmp_path), key) > 0


def test_train_main_resume_and_learner_state(tmp_path):
    """--learner-state saves the learner beside the model; the saved
    learner resumes training to more stages."""
    path, lpath = str(tmp_path / "m.pb"), str(tmp_path / "l.pkl")
    out = cli_output(tcli.train_main, ("-o", path, "--length", "2",
                                       "--n-per-oct", "2", "--min-tp", "60",
                                       "--min-fp", "60", "--seed", "1",
                                       "--learner-state", lpath) + CPU)
    assert json.loads(out.strip().splitlines()[-1])["stages"] == 2
    model = wt.load(path, device="cpu")
    learner = wt.Learner.load(lpath)
    assert len(learner) == len(model) == 2
    wt.train(model, wt.utils.fake_data_generator(seed=2), learner=learner,
             pool=wt.SamplePool(min_tp=60, min_fp=60, seed=1), length=3)
    assert len(model) == 3


def test_train_main_bbgt_dataset(tmp_path):
    """tests/test_cli.py::test_train_main_bbgt_dataset on the port: 2
    stages from a temporary bbGt directory through the native loader
    (the Python fallbacks without g++); the model loads in both
    packages."""
    img_dir, ann_dir = _write_bbgt_dataset(tmp_path)
    path = str(tmp_path / "m.pb")
    out = cli_output(tcli.train_main, (
        "-o", path, "--length", "2", "--n-per-oct", "2", "--min-tp", "50",
        "--min-fp", "50", "--seed", "0", "--images", img_dir,
        "--annotations", ann_dir) + CPU)
    assert json.loads(out.strip().splitlines()[-1])["stages"] == 2
    assert len(wt.load(path, device="cpu")) == 2
    assert len(wb.Model.load(path)) == 2


def test_detect_main_golden_on_cpu(golden, tmp_path):
    """chip_smoke.py phase 7d on the CPU: 8 VGA scenes with
    flagship_synth_64 (BucketedDetector) give JAX's JSON; with
    flagship_hard_64 too (wt.detect) JAX's rows."""
    paths = write_cli_frames(str(tmp_path))
    dev = torch.device("cpu")
    one = cli_detect_golden_run(dev, golden, paths, 1)
    two = cli_detect_golden_run(dev, golden, paths, 2)
    assert sum(len(r["boxes"]) for r in one) > 0
    assert all(r["labels"] == [] for r in one)
    assert {lb for r in two for lb in r["labels"]} == {0, 1}


def test_detect_main_two_models_matches_jax(tmp_path):
    """detect_main with two models live against JAX's on three 240 x 320
    scenes, with the score threshold and NMS options: each file's rows
    equal (one model: the golden replay above and the float frame
    below)."""
    gen = scene_generator(seed=100, hw=(240, 320))
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"f{i}.npy"))
        np.save(paths[-1], next(gen)["image"])
    args = cli_detect_args(2, paths) + ["--iou-threshold", "0.3",
                                        "--score-threshold", "1.5"]
    want = cli_json(cli_output(jcli.detect_main, args))
    got = cli_json(cli_output(tcli.detect_main, args + list(CPU)))
    assert sum(len(r["boxes"]) for r in got) > 0
    assert all(s >= 1.5 for r in got for s in r["scores"])
    assert cli_rows(got) == cli_rows(want)


def test_detect_main_float_frame_matches_jax(tmp_path):
    """A float32 .npy frame keeps its dtype (_load_gray) and takes the
    exact float path (kernel B2d on the card); its JSON equals JAX's."""
    frame = next(scene_generator(seed=101, hw=(240, 320)))["image"]
    path = str(tmp_path / "float.npy")
    np.save(path, frame.astype(np.float32) + 0.25)
    assert tcli._load_gray(path).dtype == np.float32
    args = cli_detect_args(1, [path]) + ["--iou-threshold", "0.3",
                                         "--bucket", "64"]
    want = cli_json(cli_output(jcli.detect_main, args))
    got = cli_json(cli_output(tcli.detect_main, args + list(CPU)))
    assert got == want and len(got[0]["boxes"]) > 0


def test_load_gray_matches_jax(tmp_path):
    import cv2
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    for name, write in (("c.npy", lambda p: np.save(p, rgb)),
                        ("c.png", lambda p: cv2.imwrite(p, rgb))):
        path = str(tmp_path / name)
        write(path)
        got, want = tcli._load_gray(path), jcli._load_gray(path)
        assert got.dtype == want.dtype and got.shape == (20, 30)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(IOError):
        tcli._load_gray(str(tmp_path / "missing.png"))


def test_bench_main_not_ported():
    with pytest.raises(NotImplementedError, match="A4"):
        tcli.bench_main([])


def test_console_scripts_named():
    """pyproject.toml names the port's three commands beside JAX's and
    ships the loader source as package data."""
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        text = f.read()
    for cmd, fn in (("detect", "detect_main"), ("train", "train_main"),
                    ("bench", "bench_main")):
        assert f'waldboost-torch-{cmd} = "waldboost_tpu_torch.cli:{fn}"' \
            in text
        assert f'waldboost-{cmd} = "waldboost_tpu.cli:{fn}"' in text
    assert '"native/loader.cpp"' in text
