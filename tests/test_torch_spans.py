"""PyTorch port: the serving path's ``wb.nms.round`` and ``wb.sync``
profiler spans (``waldboost_tpu_torch/profiling.py::span``).

On the CPU, greedy NMS (``ops/nms.py::nms``) records one ``wb.nms.round``
a round, as many as the most boxes a frame of the batch keeps, and one
``wb.sync`` a test of the loop, one more; both inside ``wb.nms``.  On the
card (``cuda`` marker; ``python -m pytest tests/test_torch_spans.py -m
cuda``), every point where a serving path's host waits for the card is a
``wb.sync`` span: under ``torch.cuda.set_sync_debug_mode("warn")`` a call
warns as many times as it records ``wb.sync``."""

import os
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import waldboost_tpu_torch as wt
from waldboost_tpu_torch.ops.nms import nms
from waldboost_tpu_torch.parallel.detect import BucketedDetector
from waldboost_tpu_torch.utils import scene_generator

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "models", "flagship_synth_64.pb")
HW = (96, 128)
NEW_SPANS = ("wb.nms.round", "wb.sync")


def _scenes(n=4, hw=HW, seed=5):
    """Scene frames whose boxes the flagship keeps unevenly under NMS
    (8, 7, 5 and 3 at 0.5)."""
    g = scene_generator(seed=seed, hw=hw)
    return np.stack([next(g)["image"] for _ in range(n)])


def _traced(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, [e for e in prof.events() if e.name.startswith("wb.")]


def _count(events, name):
    return sum(e.name == name for e in events)


def _inside(events, name, outer):
    """Whether every ``name`` span lies inside some ``outer`` span."""
    spans = [e.time_range for e in events if e.name == outer]
    return all(any(o.start <= e.time_range.start
                   and e.time_range.end <= o.end for o in spans)
               for e in events if e.name == name)


@pytest.mark.parametrize("nms_iou", [0.5, 0.3, None])
def test_nms_spans_count_rounds_and_reads(nms_iou):
    model = wt.load(FLAGSHIP, device="cpu")
    fn, _ = wt.make_batched_detector_boxes(model, HW, k=256, nms_iou=nms_iou,
                                           device="cpu")
    frames = torch.from_numpy(_scenes())
    plain = fn(frames)
    traced, events = _traced(fn, frames)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    if nms_iou is None:
        assert not {"wb.nms", *NEW_SPANS} & {e.name for e in events}
        return
    kept = traced[2].sum(dim=1).tolist()
    assert len(set(kept)) > 1 and max(kept) > 0
    assert _count(events, "wb.nms.round") == max(kept)
    assert _count(events, "wb.sync") == max(kept) + 1
    for name in NEW_SPANS:
        assert _inside(events, name, "wb.nms")


def test_nms_rounds_follow_the_fullest_frame():
    """Five disjoint boxes in the last row, two in the middle one, none
    in the first: five rounds and six reads; no box at all: one read."""
    x = torch.arange(5, dtype=torch.float32) * 10
    rects = torch.stack([x, x, x + 5, x + 5], dim=1).expand(3, 5, 4)
    scores = torch.linspace(1, 0, 5).expand(3, 5)
    valid = torch.tensor([[False] * 5, [True, True] + [False] * 3,
                          [True] * 5])
    keep, events = _traced(nms, rects, scores, valid, 0.5)
    assert torch.equal(keep, valid)
    assert (_count(events, "wb.nms.round"), _count(events, "wb.sync")) \
        == (5, 6)
    keep, events = _traced(nms, rects, scores, valid & False, 0.5)
    assert not keep.any()
    assert (_count(events, "wb.nms.round"), _count(events, "wb.sync")) \
        == (0, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _serving_call(path, model, frames, device):
    """One call of serving ``path`` over numpy ``frames``, NMS at 0.5."""
    if path == "detect_batch":
        return lambda: wt.detect_batch(model, frames, k=1024)
    if path == "bucketed":
        det = BucketedDetector(model, bucket=64, k=1024, nms_iou=0.5,
                               device=device)
        return lambda: det.detect_many(list(frames))
    opts = {"dense": {}, "two_phase": {"two_phase": True},
            "rowwise": {"extractor": "rowwise"}}[path]
    fn, _ = wt.make_batched_detector_boxes(model, frames.shape[1:], k=1024,
                                           nms_iou=0.5, device=device, **opts)
    images = torch.from_numpy(frames).to(device)
    return lambda: fn(images)


def _waits(call):
    """``(waits, n_sync)``: for each synchronizing CUDA operation of
    ``call()`` under ``torch.cuda.set_sync_debug_mode("warn")``, the
    innermost line of the program on its stack; the ``wb.sync`` spans the
    call recorded."""
    program = os.path.join(ROOT, "waldboost_tpu_torch")
    waits = []

    def note(message, category, filename, lineno, file=None, line=None):
        # not the one-time notice that the debug mode is a prototype
        if "synchronizing CUDA operation" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(program)]
        at = ours[-1] if ours else None
        waits.append(f"{os.path.relpath(at.filename, ROOT)}:{at.lineno}"
                     if at else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    return waits, sum(e.name == "wb.sync" for e in prof.events())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "two_phase", "rowwise",
                                  "bucketed", "detect_batch"])
def test_every_host_wait_is_a_sync_span_on_card(cuda, path):
    model = wt.load(FLAGSHIP, device=cuda)
    call = _serving_call(path, model, _scenes(), cuda)
    # tables, kernels and the profiler set up: nothing left to build
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    torch.cuda.synchronize()
    waits, n_sync = _waits(call)
    assert n_sync > 0
    assert len(waits) == n_sync, (path, n_sync, sorted(
        (w, waits.count(w)) for w in set(waits)))
