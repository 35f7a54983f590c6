"""PyTorch port: the seam every kernel wrapper calls its CUDA kernel
through (``waldboost_tpu_torch/_build.py``: ``on_card``, ``entry``,
``launch`` and the ``launches`` table).

On the CPU each of the 13 kernels' wrappers gives its plain version's
output bit for bit and counts no launch, and a tensor on a device that is
neither the CPU nor CUDA (``meta``) raises a ValueError naming the
operation.  On a card (``-m cuda``) one dense VGA call counts exactly the
launches of the serving path, and its extraction puts one kernel (S2 with
its box epilogue) and its memset on the card:

    python -m pytest tests/test_torch_launch.py -m cuda
"""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import packing, polyphase
from waldboost_tpu_torch._build import launches
from waldboost_tpu_torch.channels import level_octaves
from waldboost_tpu_torch.ops import cascade as tc
from waldboost_tpu_torch.ops import cascade_static as tcs
from waldboost_tpu_torch.ops import channels as tcc
from waldboost_tpu_torch.ops import fpga as tfp
from waldboost_tpu_torch.ops import nms as tnms
from waldboost_tpu_torch.ops import octaves as toc
from waldboost_tpu_torch.ops import planes as tpl

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "models", "flagship_synth_64.pb")
HW, B, WINDOW, C = (48, 64), 2, (8, 8), 4
#: the canvas of the cascade cases: C channels, 30 x 40
CANVAS = (B, C, 30, 40)

#: every kernel's name in ``launches``
KERNELS = ("planes", "grad_hist", "grad_hist_float", "grad_hist_fast",
           "fpga", "cascade", "cascade_fast", "cascade_response",
           "cascade_generic", "cascade_suffix", "compact", "nms", "octaves")


def _stages(rng, n):
    """``n`` seeded complete depth-2 stages over WINDOW and C channels,
    thresholds in the canvas's [0, 1) range."""
    return [dict(feature=np.stack([rng.randint(0, WINDOW[0], 7),
                                   rng.randint(0, WINDOW[1], 7),
                                   rng.randint(0, C, 7)], 1),
                 threshold=rng.uniform(0, 1, 7).astype(np.float32),
                 left=np.array([1, 3, 5, -1, -1, -1, -1]),
                 right=np.array([2, 4, 6, -1, -1, -1, -1]),
                 prediction=rng.randn(7).astype(np.float32))
            for _ in range(n)]


def _cascade_on(casc, device):
    """``casc``'s tables on ``device``, its host copies the CPU tables'
    (a meta tensor has no values to copy back)."""
    out = object.__new__(tc.Cascade)
    for f in dataclasses.fields(casc):
        object.__setattr__(out, f.name, getattr(casc, f.name).to(device))
    out.__dict__["host"] = casc.host
    return out


def _case(kernel, dev):
    """``(call, plain, what)``: the wrapper's call on inputs on ``dev``,
    its plain version's on the same inputs, and the name its errors
    carry."""
    rng = np.random.RandomState(KERNELS.index(kernel))
    packed = packing._packed_plan_cached(HW[0], HW[1], 2, 2, WINDOW, halo=1)
    tables = polyphase.plane_tables(packed, packed.halo, HW)
    images = torch.from_numpy(rng.randint(0, 256, (B,) + HW)
                              .astype(np.uint8))
    octs = tpl.octave_buffer(level_octaves(images, len(tables.oct_hw)))
    planes = tpl.planes_plain(octs, tpl.PlaneOperands.build(tables, "cpu"))
    mask = torch.from_numpy(packed.smooth_interior_mask().astype(np.uint8))
    canvas = torch.from_numpy(rng.rand(*CANVAS).astype(np.float32))
    gu, gv = CANVAS[2] - WINDOW[0], CANVAS[3] - WINDOW[1]
    valid = torch.from_numpy((rng.rand(gu, gv) < 0.9).astype(np.uint8))
    stages = _stages(rng, 6)
    theta = [-0.4, -np.inf, -0.3, -0.2, -np.inf, -0.1]
    tab = tc.stage_tables(stages)
    sc = tcs.StaticCascade(*(tab[k] for k in tc.NODE_KEYS),
                           np.asarray(theta, np.float32))
    ops = tcs.CascadeOperands.build(sc, WINDOW, C, dev)
    on = lambda *ts: [t.to(dev) for t in ts]
    if kernel == "planes":
        pops = tpl.PlaneOperands.build(tables, dev)
        o, = on(octs)
        return (lambda: tpl.planes(o, pops),
                lambda: tpl.planes_plain(o, pops), "planes")
    if kernel in ("grad_hist", "grad_hist_fast"):
        p, m = on(planes, mask)
        fn = getattr(tcc, kernel)
        plain = getattr(tcc, kernel + "_plain")
        return (lambda: fn(p, m, 1), lambda: plain(p, m, 1), "grad_hist")
    if kernel == "grad_hist_float":
        p, m = on(torch.from_numpy(rng.rand(*planes.shape)
                                   .astype(np.float32) * 256), mask)
        return (lambda: tcc.grad_hist_float(p, m, 1),
                lambda: tcc.grad_hist_float_plain(p, m, 1), "grad_hist")
    if kernel == "fpga":
        ring = torch.from_numpy((rng.rand(2, 2, *planes.shape[3:]) < 0.8)
                                .astype(np.uint8))
        p, r, m = on(planes, ring, mask)
        kind = "grad_hist_4_u1+grad_mag_u1"
        return (lambda: tfp.fpga_channels(p, r, m, kind, 1),
                lambda: tfp.fpga_channels_plain(p, r, m, kind, 1),
                "fpga_channels")
    if kernel in ("cascade", "cascade_fast"):
        cv, v = on(canvas if kernel == "cascade"
                   else canvas.to(torch.bfloat16), valid)
        return (lambda: tcs.cascade_masked(cv, v, ops),
                lambda: tcs.cascade_masked_plain(cv, v, ops), "cascade")
    if kernel == "cascade_response":
        cv, v = on(canvas, valid)
        return (lambda: tcs.cascade_response(cv, v, ops, 4),
                lambda: tcs.cascade_response_plain(cv, v, ops, 4), "cascade")
    if kernel == "cascade_generic":
        casc = _cascade_on(tc.cascade_from_stages(stages, theta,
                                                  device="cpu")[0], dev)
        cv, v = on(canvas, valid)
        return (lambda: tc.cascade_response_grid(cv, casc, WINDOW, v),
                lambda: tc.cascade_response_grid_plain(cv, casc, WINDOW, v),
                "cascade")
    if kernel == "cascade_suffix":
        S = 50
        idx = torch.from_numpy(rng.randint(0, gu * gv, (B, S)))
        scores = torch.from_numpy(rng.randn(B, S).astype(np.float32))
        alive = torch.from_numpy(rng.rand(B, S) < 0.7)
        args = on(canvas.to(torch.bfloat16), idx, scores, alive)
        cv, i, s, a = args
        return (lambda: tc.cascade_suffix_sparse(cv, ops, WINDOW, None, i, s,
                                                 a, 2),
                lambda: tc.cascade_suffix_sparse_plain(cv, ops, WINDOW, None,
                                                       i, s, a, 2),
                "cascade")
    if kernel == "compact":
        vals = np.where(rng.rand(B, 500) < 0.3, rng.randn(B, 500),
                        -np.inf).astype(np.float32)
        v, = on(torch.from_numpy(vals))
        return (lambda: tnms.topk_masked(v, 40),
                lambda: tnms.topk_masked_plain(v, 40), "topk_masked")
    if kernel == "nms":
        xy = rng.uniform(0, 100, (B, 60, 2))
        wh = rng.uniform(5, 30, (B, 60, 2))
        rects = torch.from_numpy(np.concatenate([xy, xy + wh], 2)
                                 .astype(np.float32))
        r, s, v = on(rects, torch.from_numpy(rng.rand(B, 60)
                                             .astype(np.float32)),
                     torch.from_numpy(rng.rand(B, 60) < 0.9))
        return (lambda: tnms.nms(r, s, v, 0.5),
                lambda: tnms.nms_plain(r, s, v, 0.5), "nms")
    assert kernel == "octaves"
    im, = on(images)
    return (lambda: toc.octaves(im, 4), lambda: toc.octaves_plain(im, 4),
            "octaves")


def _bits(t):
    """A tensor's values as bits (floats compared bit for bit)."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_is_plain_on_cpu_and_refuses_other_devices(kernel):
    """A CPU tensor takes the plain version, bit for bit, and launches
    nothing; a meta tensor raises a ValueError naming the operation."""
    call, plain, what = _case(kernel, "cpu")
    before = collections.Counter(launches)
    got = _flat(call())
    assert launches == before
    want = _flat(plain())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))
    call, _, what = _case(kernel, "meta")
    with pytest.raises(ValueError, match=f"^{what}: unsupported device "
                                         "meta"):
        call()
    assert launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dense_vga_call_counts_the_path_launches(cuda):
    """One dense VGA call (k 1024, NMS 0.5) of a warm detector launches
    S4, B1, B2, B3, S2 and S3 once each, and nothing else."""
    model = wt.load(FLAGSHIP, device=cuda)
    fn, _ = wt.make_batched_detector_boxes(model, (480, 640), k=1024,
                                           nms_iou=0.5, device=cuda)
    images = torch.from_numpy(np.random.RandomState(25).randint(
        0, 256, (8, 480, 640)).astype(np.uint8)).to(cuda)
    fn(images)  # tables and kernels set up
    torch.cuda.synchronize()
    before = collections.Counter(launches)
    fn(images)
    torch.cuda.synchronize()
    assert launches - before == collections.Counter({
        "octaves": 1, "planes": 1, "grad_hist": 1, "cascade": 1,
        "compact": 1, "compact/boxes": 1, "nms": 1})


@pytest.mark.cuda
def test_dense_extraction_is_one_launch(cuda, tmp_path):
    """The dense VGA call's ``wb.extract`` span puts S2 (its box epilogue
    writing every output) and its workspace memset on the card, and no
    other device operation; a compaction (``compact_survivors``) launches
    S2 without the epilogue."""
    model = wt.load(FLAGSHIP, device=cuda)
    fn, _ = wt.make_batched_detector_boxes(model, (480, 640), k=1024,
                                           nms_iou=0.5, device=cuda)
    images = torch.from_numpy(np.random.RandomState(26).randint(
        0, 256, (8, 480, 640)).astype(np.uint8)).to(cuda)
    fn(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(images)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span, = [e for e in ev if e.get("cat") == "user_annotation"
             and e["name"] == "wb.extract"]
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    corr = {e["args"]["correlation"] for e in ev
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})}
    owned = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                               "gpu_memset")
             and e.get("args", {}).get("correlation") in corr]
    assert sorted(e["cat"] for e in owned) == ["gpu_memset", "kernel"], owned
    assert "topk_kernel" in [e for e in owned if e["cat"] == "kernel"][0][
        "name"]
    masked = fn.cascade(fn.canvas(images))[0]
    before = collections.Counter(launches)
    tnms.compact_survivors(masked, None, 512)
    torch.cuda.synchronize()
    assert launches - before == collections.Counter(compact=1)
