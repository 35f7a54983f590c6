"""PyTorch port: kernel S3 (``ops/nms.py::nms``, ``csrc/nms.cu``), greedy
NMS of a batch in one launch, held bitwise against its plain version
``nms_plain`` (the greedy loop) on the same CUDA tensors, and launched once
by a call of each serving path.

Run on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_nms_kernel.py -m cuda

Without a card the card tests skip (the check is made in a fixture, so
every pytest worker collects the same tests).  The CPU tests hold the
boundary pairs the card tests place: boxes at an IoU of exactly
``float32(thr)`` and one ulp either side, which ``nms_plain`` keeps, keeps
and drops."""

import os

import numpy as np
import pytest
import torch

import waldboost_tpu_torch as wt
from waldboost_tpu_torch.ops import nms as nms_mod
from waldboost_tpu_torch.ops.nms import nms, nms_plain
from waldboost_tpu_torch.parallel import bucket as bucket_mod
from waldboost_tpu_torch.parallel import detect as detect_mod
from waldboost_tpu_torch.parallel.detect import BucketedDetector
from waldboost_tpu_torch.parallel.mesh import make_mesh
from waldboost_tpu_torch.utils import scene_generator

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "models", "flagship_synth_64.pb")
HARD64 = os.path.join(ROOT, "models", "flagship_hard_64.pb")
HW = (96, 128)
F32 = np.float32
#: where the boundary pairs sit: clear of the clouds of boxes in [0, 100]^2
PAIR_ORIGINS = ((-40.0, -40.0), (-40.0, -36.0), (-40.0, -32.0))


def _iou32(a, b):
    """The plain loop's float32 IoU of XYXY boxes ``a`` (the pick) and
    ``b``, each operation rounded to float32 in the loop's order."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    area = lambda r: np.maximum(r[..., 2] - r[..., 0], F32(0)) \
        * np.maximum(r[..., 3] - r[..., 1], F32(0))
    iw = np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])
    ih = np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])
    inter = np.maximum(iw, F32(0)) * np.maximum(ih, F32(0))
    union = (area(a) + area(b)) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, F32(0)).astype(F32)


def _boundary_pairs(thr):
    """Three pairs ``(a, b)`` of float32 boxes, one at each of
    PAIR_ORIGINS, whose IoU is one ulp below ``float32(thr)``, exactly it,
    and one ulp above: ``a`` the unit square, ``b`` a box from inside its
    left edge past its right one, lower than it, found by a search over
    b's corners on the float32 grid."""
    t = F32(thr)
    targets = (np.nextafter(t, F32(-1)), t, np.nextafter(t, F32(2)))
    pairs = []
    for (ox, oy), want in zip(PAIR_ORIGINS, targets):
        a = np.array([ox, oy, ox + 1, oy + 1], F32)
        d, h = np.meshgrid(np.linspace(0.0, 0.3, 64), np.linspace(0.6, 0.95,
                                                                  64))
        x1 = (F32(ox) + d.ravel().astype(F32)).astype(F32)
        y2 = (F32(oy) + h.ravel().astype(F32)).astype(F32)
        # inter = iw * bh; the width where inter / union = want, then the
        # float32 corners around it
        iw = (a[2] - x1).astype(np.float64)
        bh = (y2 - F32(oy)).astype(np.float64)
        inter = iw * bh
        bw = (inter / float(want) - 1 + inter) / bh
        x2 = (x1 + bw.astype(F32)).astype(F32)
        for step in range(-8, 9):
            xs = x2.copy()
            for _ in range(abs(step)):
                xs = np.nextafter(xs, F32(np.sign(step) * np.inf))
            b = np.stack([x1, np.full_like(xs, oy), xs, y2], axis=1)
            hit = np.flatnonzero((_iou32(a[None], b) == want)
                                 & (xs > a[2]))
            if hit.size:
                pairs.append((a, b[hit[0]]))
                break
        else:
            raise AssertionError(f"no pair at IoU {want!r}")
    return pairs


def _candidates(B, K, kind, thr, seed):
    """``(rects, scores, valid)`` as float32, float32 and bool numpy arrays
    (B, K, 4), (B, K), (B, K) of candidate sets of ``kind``: boxes in
    clouds (so NMS drops many), scores unsorted (``sorted``: descending
    as the extraction gives them; ``ties``: four values; ``nan``: a tenth
    NaN where valid), ``zero_area`` boxes of width or height 0 and
    empty ones, ``invalid`` nothing valid, ``neg_inf0`` a valid -inf
    score at index 0; every set of 16 or more holds the boundary pairs."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(10, 90, (B, 6, 2))
    c = centres[np.arange(B)[:, None], rng.integers(0, 6, (B, K))] \
        + rng.normal(0, 4, (B, K, 2))
    wh = rng.uniform(4, 20, (B, K, 2))
    if kind == "zero_area":
        wh[rng.random((B, K)) < 0.2, 0] = 0
        wh[rng.random((B, K)) < 0.2, 1] = 0
        wh[rng.random((B, K)) < 0.05] = -1
    rects = np.concatenate([c - wh / 2, c + wh / 2], axis=2).astype(F32)
    if kind == "ties":
        scores = rng.integers(0, 4, (B, K)).astype(F32)
    else:
        scores = rng.normal(0, 1, (B, K)).astype(F32)
    if kind == "sorted":
        scores = -np.sort(-scores, axis=1)
    valid = rng.random((B, K)) < 0.85
    if kind == "invalid":
        valid[:] = False
    if kind == "nan":
        scores[(rng.random((B, K)) < 0.1) & valid] = np.nan
    if kind == "neg_inf0":
        scores[:, 0], valid[:, 0] = -np.inf, True
    if K >= 16:
        at = rng.choice(np.arange(1, K - 1, 2), 3, replace=False)
        for j, (a, b) in zip(at, _boundary_pairs(thr)):
            rects[:, j], rects[:, j + 1] = a, b
            scores[:, j], scores[:, j + 1] = 10.0, 9.0
            valid[:, j] = valid[:, j + 1] = kind != "invalid"
    if kind == "sorted":
        order = np.argsort(-scores, axis=1, kind="stable")
        take = lambda x: np.take_along_axis(
            x, order.reshape(order.shape + (1,) * (x.ndim - 2)), axis=1)
        rects, scores, valid = take(rects), take(scores), take(valid)
    return rects, scores, valid


# -- CPU: the boundary pairs ------------------------------------------------

@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_boundary_pairs_sit_at_the_threshold(thr):
    """Each pair's IoU, as the port computes it, is float32(thr) less an
    ulp, float32(thr), and float32(thr) plus an ulp."""
    t = F32(thr)
    got = [nms_mod.iou_matrix_device(torch.from_numpy(a[None]),
                                     torch.from_numpy(b[None]))[0, 0].item()
           for a, b in _boundary_pairs(thr)]
    assert got == [np.nextafter(t, F32(-1)), t, np.nextafter(t, F32(2))]


@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_plain_loop_drops_only_above_the_float32_threshold(thr):
    """A box at IoU exactly float32(thr) with a kept one is kept, one ulp
    above it is dropped: the threshold compares as a float32."""
    pairs = _boundary_pairs(thr)
    rects = torch.from_numpy(np.stack([np.stack(p) for p in pairs]))
    scores = torch.tensor([[1.0, 0.5]]).expand(3, 2)
    keep = nms_plain(rects, scores, torch.ones(3, 2, dtype=torch.bool), thr)
    assert keep.tolist() == [[True, True], [True, True], [True, False]]


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _on(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


KINDS = ("random", "sorted", "ties", "nan", "zero_area", "invalid",
         "neg_inf0")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("thr", [0.3, 0.5])
@pytest.mark.parametrize("K", [1, 5, 128, 1000, 1024, 1025, 12000])
@pytest.mark.parametrize("B", [1, 8])
def test_kernel_is_the_plain_loop(cuda, B, K, thr, kind):
    """S3 bitwise ``nms_plain`` on the same CUDA tensors, in one launch;
    K = 12000 takes the kernel's global-memory form."""
    rects, scores, valid = _on(cuda, *_candidates(B, K, kind, thr,
                                                  seed=B * 100003 + K))
    want = nms_plain(rects, scores, valid, thr)
    before = nms_mod.nms_launches
    got = nms(rects, scores, valid, thr)
    torch.cuda.synchronize()
    assert nms_mod.nms_launches == before + 1
    assert got.dtype == torch.bool and got.shape == (B, K)
    assert torch.equal(got, want), (got ^ want).nonzero()[:8].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [5, 1024, 12000])
def test_neg_inf_scores_end(cuda, K):
    """Valid -inf scores away from index 0, where the plain loop never
    ends: S3 ends (at most K rounds) and keeps what the loop keeps with
    each such score as the lowest float32 instead."""
    rects, scores, valid = _candidates(8, K, "random", 0.5, seed=K)
    valid[:, 0] = False
    ninf = np.zeros((8, K), bool)
    ninf[:, 1::3] = True
    scores[ninf] = -np.inf
    valid |= ninf
    low = np.where(ninf, np.finfo(F32).min, scores).astype(F32)
    rects, scores, low, valid = _on(cuda, rects, scores, low, valid)
    got = nms(rects, scores, valid, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_plain(rects, low, valid, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(0, 16), (4, 0), (0, 0)])
def test_empty_batch_makes_no_launch(cuda, B, K):
    before = nms_mod.nms_launches
    keep = nms(torch.zeros(B, K, 4, device=cuda), torch.zeros(B, K,
                                                              device=cuda),
               torch.ones(B, K, dtype=torch.bool, device=cuda), 0.5)
    assert nms_mod.nms_launches == before
    assert keep.shape == (B, K) and keep.dtype == torch.bool


@pytest.mark.cuda
def test_kernel_refuses_other_types(cuda):
    rects = torch.zeros(2, 3, 4, device=cuda)
    scores = torch.zeros(2, 3, device=cuda)
    valid = torch.ones(2, 3, dtype=torch.bool, device=cuda)
    for args in ((rects.double(), scores, valid),
                 (rects, scores.half(), valid),
                 (rects, scores, valid.to(torch.uint8)),
                 (rects[:, :2], scores, valid)):
        with pytest.raises(ValueError):
            nms(*args, 0.5)


def _scenes(n=4, hw=HW, seed=5):
    """Scene frames whose boxes the flagship keeps unevenly under NMS."""
    g = scene_generator(seed=seed, hw=hw)
    return np.stack([next(g)["image"] for _ in range(n)])


def _serving_call(path, device):
    """``(call, launches)``: one call of serving ``path`` on the scene
    frames, NMS at 0.5, and the S3 launches it should make."""
    model = wt.load(FLAGSHIP, device=device)
    frames = _scenes()
    images = torch.from_numpy(frames).to(device)
    if path == "model_detect_topk":
        return (lambda: model.detect_topk(frames[0], k=1024, nms_iou=0.5),
                1)
    if path == "bucketed":
        det = BucketedDetector(model, bucket=64, k=1024, nms_iou=0.5,
                               device=device)
        return lambda: det.detect_many(list(frames)), 1
    if path == "multi":
        hard = wt.load(HARD64, device=device)
        fn, _ = wt.make_multi_detector_boxes(
            [model, hard], HW, k=1024, nms_iou=0.5, response_scale=[1, 0.5],
            device=device)
        return lambda: fn(images), 2
    if path == "mesh":
        fn, _ = wt.make_batched_detector_boxes(
            model, HW, k=1024, nms_iou=0.5,
            mesh=make_mesh(devices=[device, device]))
        return lambda: fn(images), 2
    opts = {"dense": {}, "two_phase": {"two_phase": True},
            "rowwise": {"extractor": "rowwise"}}[path]
    fn, _ = wt.make_batched_detector_boxes(model, HW, k=1024, nms_iou=0.5,
                                           device=device, **opts)
    return lambda: fn(images), 1


def _flat(out):
    """The call's outputs as a list of tensors or numpy arrays."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flat(o)]
    if isinstance(out, wt.Boxes):
        return [out.get()] + [out.get_field(f) for f in out.field_names()]
    return [np.asarray(out)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "two_phase", "rowwise", "multi",
                                  "bucketed", "mesh", "model_detect_topk"])
def test_serving_call_launches_s3_once(cuda, path, monkeypatch):
    """A call launches S3 once (once a model of the multi-model path and
    a shard of the mesh), and its outputs are bitwise those of the same
    call with the plain loop in S3's place."""
    call, want = _serving_call(path, cuda)
    call()  # tables and kernels set up
    before = nms_mod.nms_launches
    got = _flat(call())
    torch.cuda.synchronize()
    assert nms_mod.nms_launches - before == want
    for mod in (nms_mod, detect_mod, bucket_mod):
        monkeypatch.setattr(mod, "nms", nms_plain)
    plain = _flat(call())
    assert nms_mod.nms_launches - before == want
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)
