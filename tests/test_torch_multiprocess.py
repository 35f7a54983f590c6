"""The port's mesh across two processes (``torch.distributed`` over gloo on
the CPU), the counterpart of tests/test_multiprocess.py.

Two processes with 4 CPU shards each must train the SAME model and give
the SAME detections as one process with 8 shards: the stage step gathers
the pools and computes replicated, mining is the same seeded stream in
every process, and each process inserts the rows of its own shards.
Both layouts, teacher-forced with the trees of
``tests/data/torch_port_mesh_golden.npz`` (JAX's
``tests/mp_worker.py::run_program`` over 8 devices,
``scripts/make_torch_mesh_golden.py``), give the golden's model and
detections: on the scene frames the kept boxes are the host NMS's over
the golden's candidates in extraction order (JAX's device NMS may round
a pair at IoU exactly 1/2 the other way).  Tolerances: trees, thetas and
detections bitwise; losses within 1e-6 (torch's ``exp`` and sum order
against XLA's).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from waldboost_tpu.boxes import Boxes as JBoxes
from waldboost_tpu.boxes import non_max_suppression as jax_host_nms

from torch_mp_worker import run_program, scene_frames
from torch_port_util import sorted_rows

from waldboost_tpu_torch.parallel.mesh import make_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "data", "torch_port_mesh_golden.npz")
STAGE_KEYS = ("feature", "threshold", "left", "right", "prediction")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The program (free, then teacher-forced) in two gloo processes of
    4 CPU shards each, and in this process over 8 CPU shards."""
    tmp = tmp_path_factory.mktemp("mp")
    out = str(tmp / "mp.npz")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mp_worker.py"),
         "--rank", str(r), "--world", "2",
         "--init", f"file://{tmp / 'store'}", "--local-devices", "4",
         "--golden", GOLDEN, "--out", out],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker rc={p.returncode}:\n{log[-4000:]}"
    mesh = make_mesh(devices=["cpu"] * 8)
    sp = str(tmp / "sp.npz")
    run_program(mesh, sp)
    run_program(mesh, sp + ".forced.npz", forced=np.load(GOLDEN))
    return {name: np.load(path) for name, path in (
        ("mp", out), ("mp_forced", out + ".forced.npz"), ("sp", sp),
        ("sp_forced", sp + ".forced.npz"))}


def test_two_process_mesh_matches_single_process(runs):
    """The model (trees, thetas) and every detection output bitwise; the
    losses within 1e-6 (in fact equal: one step on the same gathered
    pools)."""
    mp, sp = runs["mp"], runs["sp"]
    assert set(mp.files) == set(sp.files)
    np.testing.assert_allclose(mp["losses"], sp["losses"], rtol=1e-6)
    for f in mp.files:
        if f != "losses":
            np.testing.assert_array_equal(mp[f], sp[f], err_msg=f)
    assert (sp["scene_valid"].sum(1) > 0).all()


@pytest.mark.parametrize("layout", ["mp_forced", "sp_forced"])
def test_mesh_program_matches_golden(runs, layout):
    """Teacher-forced, both layouts give JAX's model (stage tables
    bitwise, thetas as float32), its losses within 1e-6, its survivor
    counts and kept boxes (sorted rows) on the noise frames, and on the
    scene frames its counts and the host NMS of its candidates."""
    got, g = runs[layout], np.load(GOLDEN)
    for t in range(8):
        for k in STAGE_KEYS:
            np.testing.assert_array_equal(got[f"{k}{t}"], g[f"{k}{t}"],
                                          err_msg=f"{k}{t}")
    np.testing.assert_array_equal(got["theta"].astype(np.float32),
                                  g["theta"].astype(np.float32))
    np.testing.assert_allclose(got["losses"], g["losses"], rtol=1e-6)
    assert scene_frames().shape == (8, 256, 256)
    for prefix in ("", "scene_"):
        np.testing.assert_array_equal(got[prefix + "count"],
                                      g[prefix + "count"])
        r, s, v = (got[prefix + k] for k in ("rects", "scores", "valid"))
        gr, gs, gv = (g[prefix + k] for k in ("rects", "scores", "valid"))
        for b in range(len(v)):
            want = (gr[b][gv[b]], gs[b][gv[b]])
            if prefix:
                kept = jax_host_nms(JBoxes(want[0], scores=want[1]),
                                    iou_threshold=0.5)
                want = (kept.get(), kept.get_field("scores"))
                assert v[b].sum() > 0
            np.testing.assert_array_equal(sorted_rows(r[b][v[b]], s[b][v[b]]),
                                          sorted_rows(*want))
