"""The port's meshes (``waldboost_tpu_torch/parallel/mesh.py`` and the
``mesh=`` of serving, tile sharding, the bucket, the verifier and the
device-pool trainer) against the unsharded port and the JAX package's
meshes, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices; the port on a
mesh of ``["cpu"] * n``, its stand-in for them.  Tolerances: serving
outputs, tile-sharded grids and trained models bitwise against the
unsharded port at every mesh size; against JAX, kept boxes as sorted rows
bitwise (tests/test_torch_detect.py), grids where alive bitwise, and the
trainers teacher-forced (tests/test_torch_device_train.py: trees held to
JAX's, then thetas, p0, p1 and pools bitwise, losses within 1e-6);
verified scores within 1e-5 of their scale (tests/test_torch_verifier.py).
"""

import contextlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu import fpga as jfpga
from waldboost_tpu import verification as V
from waldboost_tpu.boxes import Boxes as JBoxes
from waldboost_tpu.boxes import non_max_suppression as jax_host_nms
from waldboost_tpu.parallel import bucket as jbucket
from waldboost_tpu.parallel import detect as jdet
from waldboost_tpu.parallel import train_step as jts
from waldboost_tpu.parallel import trainer as jtrainer
from waldboost_tpu.parallel.mesh import make_mesh as jax_mesh
from waldboost_tpu.parallel.mesh import shard_array as jax_shard
from waldboost_tpu.utils import fake_data_generator as jgen

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import verification as TV
from waldboost_tpu_torch.fpga.banks import BankScheduler, PixelBanks
from waldboost_tpu_torch.parallel import DevicePool, make_train_step
from waldboost_tpu_torch.parallel import trainer as ttrainer
from waldboost_tpu_torch.parallel.detect import (BucketedDetector,
                                                 make_tile_sharded_detector)
from waldboost_tpu_torch.parallel.mesh import (as_shards, gather,
                                               is_multiprocess, make_mesh,
                                               shard_array)
from waldboost_tpu_torch.utils import fake_data_generator as tgen

from test_torch_bucket import box_set, random_pair
from test_torch_device_train import (_assert_heap_close, _seeded_pools,
                                     forced_fits)
from test_torch_multi import SCALES, _three_pairs
from test_torch_verifier import (OPTS as VOPTS, assert_close, port_model,
                                 verifier_pair)
from test_verification import _toy_pools
from torch_port_util import make_model_pair, noise_frames, sorted_rows

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (DEVICE_FPGA_TRAIN_GOLDEN,  # noqa: E402  (numpy only)
                        DEVICE_TRAIN_GOLDEN, device_train_golden_run)

torch.set_num_threads(2)

#: the mesh sizes of the sweeps (the conftest gives JAX 8 CPU devices)
NS = [1, 2, 4, 8]
TRAIN_OPTS = dict(shrink=2, n_per_oct=2, smooth=1, channels="grad_hist")


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def gathered(outs, mesh):
    """numpy arrays of each output's shards gathered in mesh order."""
    return [gather(o, mesh).numpy() for o in outs]


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


# -- the mesh ------------------------------------------------------------

def test_mesh_shards_and_gathers():
    mesh = cpu_mesh(4)
    assert mesh.size == mesh.n_local == 4 and not is_multiprocess(mesh)
    assert mesh.local_devices == (torch.device("cpu"),) * 4
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    shards = shard_array(x, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    assert gather(shards, mesh).numpy().tolist() == x.tolist()
    assert as_shards(shards, mesh) == shards
    v = torch.tensor([True, False] * 4)
    assert torch.equal(gather(shard_array(v, mesh), mesh), v)
    with pytest.raises(ValueError, match="mesh size"):
        shard_array(np.zeros((6, 2)), mesh)
    with pytest.raises(ValueError, match="shards"):
        as_shards(shards[:3], mesh)
    with pytest.raises(ValueError, match="Requested 5"):
        make_mesh(5, devices=["cpu"] * 4)
    assert make_mesh(2, devices=["cpu"] * 4).size == 2


# -- sharded serving ---------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_sharded_detect_matches_unsharded(n):
    """make_batched_detector (B4) over n shards: the unsharded port's maps
    bitwise, and JAX's sharded detector's where alive."""
    jm, tm = make_model_pair(n_stages=3, smooth=0, seed=1)
    images = noise_frames(8, (40, 56), seed=1)
    mesh = cpu_mesh(n)
    fs, _ = wt.make_batched_detector(tm, (40, 56), mesh=mesh)
    assert len(fs.parts) == n
    got = gathered(fs(images), mesh)
    fu, _ = wt.make_batched_detector(tm, (40, 56), device="cpu")
    for a, b in zip(got, fu(torch.from_numpy(images))):
        np.testing.assert_array_equal(a, b.numpy())
    jmesh = jax_mesh(n)
    fj, _ = jdet.make_batched_detector(jm, (40, 56), mesh=jmesh)
    hs, al, nw = (np.asarray(a) for a in fj(jax_shard(images, jmesh)))
    np.testing.assert_array_equal(got[1], al)
    np.testing.assert_array_equal(got[0][al], hs[al])
    np.testing.assert_array_equal(got[2], nw)


@pytest.mark.parametrize("n", NS)
def test_sharded_boxes_matches_unsharded(n):
    """make_batched_detector_boxes and detect_batch over n shards: every
    output the unsharded port's bitwise, counts, n_weak and kept rows
    JAX's sharded detector's."""
    jm, tm = make_model_pair(n_stages=8, seed=2)
    images = noise_frames(8, (48, 64), seed=3)
    mesh = cpu_mesh(n)
    fs, _ = wt.make_batched_detector_boxes(tm, (48, 64), k=512,
                                           nms_iou=0.5, mesh=mesh)
    got = gathered(fs(shard_array(images, mesh)), mesh)
    fu, _ = wt.make_batched_detector_boxes(tm, (48, 64), k=512, nms_iou=0.5,
                                           device="cpu")
    for a, b in zip(got, fu(torch.from_numpy(images))):
        np.testing.assert_array_equal(a, b.numpy())
    jmesh = jax_mesh(n)
    fj, _ = jdet.make_batched_detector_boxes(jm, (48, 64), mesh=jmesh, k=512,
                                             nms_iou=0.5)
    rj, sj, vj, cj, nwj = (np.asarray(a)
                           for a in fj(jax_shard(images, jmesh)))
    rt, st, vt, ct, nwt = got
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(nwt, nwj)
    assert (ct > 0).all()
    for b in range(len(images)):
        np.testing.assert_array_equal(sorted_rows(rt[b][vt[b]], st[b][vt[b]]),
                                      sorted_rows(rj[b][vj[b]], sj[b][vj[b]]))
    for a, b in zip(wt.detect_batch(tm, images, k=512, mesh=mesh),
                    wt.detect_batch(tm, images, k=512)):
        np.testing.assert_array_equal(a.get(), b.get())
        np.testing.assert_array_equal(a.get_field("scores"),
                                      b.get_field("scores"))


@pytest.mark.parametrize("n", NS)
def test_sharded_fast_mode_matches_unsharded(n):
    """Fast serving mode (B2f, B3f) over n shards, uint8 and float32
    frames: the unsharded fast path's outputs bitwise."""
    _, tm = make_model_pair(n_stages=8, seed=4)
    images = noise_frames(8, (48, 64), seed=5)
    mesh = cpu_mesh(n)
    for frames in (images, images.astype(np.float32) + 0.25):
        fs, _ = wt.make_batched_detector_boxes(tm, (48, 64), k=256,
                                               nms_iou=0.5, mesh=mesh,
                                               fast=True)
        fu, _ = wt.make_batched_detector_boxes(tm, (48, 64), k=256,
                                               nms_iou=0.5, device="cpu",
                                               fast=True)
        got = gathered(fs(frames), mesh)
        want = fu(torch.from_numpy(frames))
        assert (want[3] > 0).all()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())


def test_sharded_fast_mode_matches_jax():
    """Fast mode over 4 shards against JAX's WB_SERVING_MODE=fast path
    sharded over 4 devices (its Pallas kernels in interpret mode)."""
    from test_torch_fast import fast_model_pair, jax_fast

    jm, tm = fast_model_pair()
    images = noise_frames(4, (96, 128), seed=6)
    mesh, jmesh = cpu_mesh(4), jax_mesh(4)
    with jax_fast():
        fj, _ = jdet.make_batched_detector_boxes(jm, (96, 128), mesh=jmesh,
                                                 k=1024, nms_iou=0.5,
                                                 with_n_weak=False)
        rj, sj, vj, cj, _ = (np.asarray(a)
                             for a in fj(jax_shard(images, jmesh)))
    fs, _ = wt.make_batched_detector_boxes(tm, (96, 128), k=1024,
                                           nms_iou=0.5, with_n_weak=False,
                                           mesh=mesh, fast=True)
    rt, st, vt, ct, _ = gathered(fs(images), mesh)
    np.testing.assert_array_equal(ct, cj)
    for b in range(len(images)):
        np.testing.assert_array_equal(sorted_rows(rt[b][vt[b]], st[b][vt[b]]),
                                      sorted_rows(rj[b][vj[b]], sj[b][vj[b]]))


@pytest.mark.parametrize("n", NS)
def test_sharded_multi_detector_matches_unsharded(n):
    """make_multi_detector_boxes over n shards: the unsharded port's
    outputs bitwise; at 4 shards also JAX's meshed outputs' counts, n_weak
    and kept rows of each model."""
    jms, tms = _three_pairs()
    images = noise_frames(8, (96, 128), seed=24)
    mesh = cpu_mesh(n)
    kw = dict(k=512, nms_iou=0.4, response_scale=SCALES)
    fs, _ = wt.make_multi_detector_boxes(tms, (96, 128), mesh=mesh, **kw)
    got = gathered(fs(images), mesh)
    fu, _ = wt.make_multi_detector_boxes(tms, (96, 128), device="cpu", **kw)
    for a, b in zip(got, fu(torch.from_numpy(images))):
        np.testing.assert_array_equal(a, b.numpy())
    if n != 4:
        return
    jmesh = jax_mesh(4)
    fj, _ = jdet.make_multi_detector_boxes(jms, (96, 128), mesh=jmesh, **kw)
    jr, js, jv, jl, jc, jnw = (np.asarray(a) for a in fj(jnp.asarray(images)))
    rects, scores, valid, label, count, n_weak = got
    np.testing.assert_array_equal(count, jc)
    np.testing.assert_array_equal(n_weak, jnw)
    for b in range(len(images)):
        for kix in range(len(tms)):
            sel, jsel = valid[b] & (label[b] == kix), jv[b] & (jl[b] == kix)
            np.testing.assert_array_equal(
                sorted_rows(rects[b][sel], scores[b][sel]),
                sorted_rows(jr[b][jsel], js[b][jsel]))


# -- tile sharding -----------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_tile_sharded_single_image_exact(n):
    """One frame's window grid in n bands: hs, alive and n_weak of the
    unsharded B4 detector bitwise, and of JAX's tile-sharded detector
    (hs where alive)."""
    jm, tm = make_model_pair(n_stages=4, seed=9)
    image = noise_frames(1, (96, 128), seed=9)[0]
    ft, packed = make_tile_sharded_detector(tm, image.shape, cpu_mesh(n))
    hs, alive, nw = ft(image)
    fu, _ = wt.make_batched_detector(tm, image.shape, device="cpu")
    hu, au, nu = fu(torch.from_numpy(image[None]))
    assert hs.shape == hu.shape[1:] and alive.any()
    np.testing.assert_array_equal(hs.numpy(), hu[0].numpy())
    np.testing.assert_array_equal(alive.numpy(), au[0].numpy())
    assert int(nw) == int(nu[0])
    fj, _ = jdet.make_tile_sharded_detector(jm, image.shape, mesh=jax_mesh(n))
    hj, aj, nj = (np.asarray(a) for a in fj(image))
    np.testing.assert_array_equal(alive.numpy(), aj)
    np.testing.assert_array_equal(hs.numpy()[aj], hj[aj])
    assert int(nw) == int(nj)


def test_tile_sharded_boxes_extraction():
    """boxes=True over 4 bands: before NMS the survivor count and box set
    of JAX's tile-sharded extraction and of the unsharded port; with NMS
    0.5 the kept boxes are the host NMS's over the candidates in
    extraction order (JAX's device NMS may round a pair at IoU exactly
    1/2 the other way)."""
    jm, tm = make_model_pair(n_stages=4, seed=9)
    image = noise_frames(1, (96, 128), seed=9)[0]
    mesh = cpu_mesh(4)
    ft, _ = make_tile_sharded_detector(tm, image.shape, mesh, boxes=True,
                                       k=4096)
    rt, st, vt, ct, nwt = (_np(a) for a in ft(image))
    fj, _ = jdet.make_tile_sharded_detector(jm, image.shape, mesh=jax_mesh(4),
                                            boxes=True, k=4096)
    rj, sj, vj, cj, nwj = (np.asarray(a) for a in fj(image))
    assert int(ct) == int(cj) > 0 and int(nwt) == int(nwj)
    np.testing.assert_array_equal(sorted_rows(rt[vt], st[vt]),
                                  sorted_rows(rj[vj], sj[vj]))
    fu, _ = wt.make_batched_detector_boxes(tm, image.shape, k=4096,
                                           with_n_weak=False, device="cpu")
    ru, su, vu, cu, _ = (a[0].numpy()
                         for a in fu(torch.from_numpy(image[None])))
    assert int(cu) == int(ct)
    np.testing.assert_array_equal(rt, ru)
    np.testing.assert_array_equal(st, su)

    fn, _ = make_tile_sharded_detector(tm, image.shape, mesh, boxes=True,
                                       k=4096, nms_iou=0.5)
    rk, sk, vk, _, _ = (_np(a) for a in fn(image))
    host = jax_host_nms(JBoxes(rt[vt], scores=st[vt]), iou_threshold=0.5)
    assert 0 < vk.sum() < vt.sum()
    np.testing.assert_array_equal(sorted_rows(rk[vk], sk[vk]),
                                  sorted_rows(host.get(),
                                              host.get_field("scores")))


# -- bucket and verifier -------------------------------------------------------

def test_bucketed_mesh_matches_unmeshed():
    """BucketedDetector(mesh=4) on tests/test_bucketed.py's frames with a
    random cascade that keeps windows: the unmeshed port's boxes and JAX's
    meshed bucket's, also for a group whose frame count the mesh does not
    divide."""
    jm, tm = random_pair()
    rng = np.random.RandomState(5)
    imgs = [rng.randint(0, 256, (45, 60)).astype(np.uint8)
            for _ in range(4)]
    odd = [rng.randint(0, 256, (40, 52)).astype(np.uint8) for _ in range(3)]
    mesh = cpu_mesh(4)
    plain = BucketedDetector(tm, bucket=32, k=4096, device="cpu")
    meshed = BucketedDetector(tm, bucket=32, k=4096, mesh=mesh, max_batch=4)
    jmeshed = jbucket.BucketedDetector(jm, bucket=32, k=4096,
                                       mesh=jax_mesh(4), max_batch=4)
    got = meshed.detect_many(imgs + odd)
    assert len(got) == 7 and all(len(b) for b in got)
    for a, b in zip(got, plain.detect_many(imgs + odd)):
        assert box_set(a) == box_set(b)
    for a, b in zip(got, jmeshed.detect_many(imgs)):
        assert box_set(a) == box_set(b)


def test_verify_scores_mesh_matches_single_device():
    """verify_scores over 8 shards (100 windows padded to 104) against the
    unmeshed port and JAX's meshed program; detect_and_verify(mesh=)
    against the unmeshed call; one program per (params, mesh)."""
    rng = np.random.RandomState(4)
    X0, H0, _, _ = _toy_pools(rng, n=100)
    module, params, tmod, state = verifier_pair((8, 8, 4), seed=4)
    mesh = cpu_mesh(8)
    base = TV.verify_scores(tmod, state, X0, H0, device="cpu")
    sharded = TV.verify_scores(tmod, state, X0, H0, mesh=mesh)
    assert sharded.shape == (100,)
    assert_close(sharded, base)
    assert_close(sharded, V.verify_scores(module, params, X0, H0,
                                          mesh=jax_mesh(8)))
    prog = TV.get_verifier_program(tmod, state, mesh=mesh)
    assert TV.get_verifier_program(tmod, state, mesh=mesh) is prog
    assert TV.get_verifier_program(tmod, state, "cpu") is not prog

    from test_model import make_model
    jmod = make_model(n_stages=3, shape=(8, 8, 4), opts=VOPTS)
    tm = port_model(jmod)
    img = rng.randint(0, 256, (48, 64)).astype(np.uint8)
    want = TV.detect_and_verify(img, tm, tmod, state)
    got = TV.detect_and_verify(img, tm, tmod, state, mesh=cpu_mesh(4))
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.get(), want.get())
    np.testing.assert_array_equal(got.get_field("cascade_scores"),
                                  want.get_field("cascade_scores"))
    assert_close(got.get_field("scores"), want.get_field("scores"))


# -- sharded training ----------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_device_pool_mesh_insert_matches_unsharded(n):
    """DevicePool(mesh): insert and insert_from_device fill the slots, in
    global order, of the unsharded pool and of JAX's meshed pool, also
    after a stage left holes."""
    rng = np.random.RandomState(7)
    F = 24
    src = rng.randn(300, 2, 3, 4).astype(np.float32)
    sH = rng.randn(300).astype(np.float32)
    seed_x = rng.randn(40, F).astype(np.float32)
    seed_H = rng.randn(40).astype(np.float32)
    idx = np.flatnonzero(sH > 0.3)
    mesh = cpu_mesh(n)
    pu, pm = DevicePool(256, F, device="cpu"), DevicePool(256, F, mesh=mesh)
    pj = jtrainer.DevicePool(256, F, mesh=jax_mesh(n))
    assert len(pm.x) == n
    for p in (pu, pm, pj):
        p.insert(seed_x, seed_H)
    pu.insert_from_device(torch.from_numpy(src), torch.from_numpy(sH), idx)
    pm.insert_from_device(torch.from_numpy(src), torch.from_numpy(sH), idx)
    pj.insert_from_device(jnp.asarray(src), jnp.asarray(sH), idx)

    def check():
        for k in ("x", "H", "v"):
            got = gather(getattr(pm, k), mesh).numpy()
            np.testing.assert_array_equal(got, _np(getattr(pu, k)))
            np.testing.assert_array_equal(got, np.asarray(getattr(pj, k)))
        assert pm.count == pu.count == pj.count

    check()
    keep = pu.v.numpy().copy()
    keep[np.flatnonzero(keep)[::2]] = False
    Hs = pu.H.numpy() + 1
    pu.apply_stage(torch.from_numpy(Hs.copy()), torch.from_numpy(keep.copy()),
                   int(keep.sum()))
    pm.apply_stage(shard_array(Hs, mesh), shard_array(keep, mesh),
                   int(keep.sum()))
    pj.apply_stage(jax_shard(Hs, pj.mesh), jax_shard(keep, pj.mesh))
    for p in (pu, pm):
        p.insert_from_device(torch.from_numpy(src), torch.from_numpy(sH),
                             idx[::-1])
    pj.insert_from_device(jnp.asarray(src), jnp.asarray(sH), idx[::-1])
    check()


@pytest.mark.parametrize("n", NS)
def test_sharded_train_step_matches_single_device(n):
    """make_train_step(mesh) on pools with holes: the unsharded step's
    tree, theta, p0, p1, loss, counts, scores and validity bitwise; JAX's
    meshed step's tree, and with it forced the rest bitwise (loss within
    1e-6)."""
    pools = _seeded_pools(seed=2, N=512, F=32)
    args = (0.25, 0.875, -np.inf, True)
    kw = dict(alpha=0.2, max_depth=2, n_bins=64)
    mesh = cpu_mesh(n)
    r1 = make_train_step(**kw)(*(torch.from_numpy(a) for a in pools), *args)
    stepN = make_train_step(mesh=mesh, **kw)
    rN = stepN(*(shard_array(a, mesh) for a in pools), *args)
    for k in r1.tree._fields:
        assert torch.equal(getattr(r1.tree, k), getattr(rN.tree, k)), k
    for k in ("theta", "p0", "p1", "loss", "n0", "n1"):
        assert torch.equal(getattr(r1, k), getattr(rN, k)), k
    for k in ("H0", "H1", "v0", "v1"):
        assert len(getattr(rN, k)) == n
        assert torch.equal(gather(getattr(rN, k), mesh), getattr(r1, k)), k

    jmesh = jax_mesh(n)
    jstep = jts.make_train_step(mesh=jmesh, **kw)
    want = jstep(*(jax_shard(a, jmesh) for a in pools), np.float32(0.25),
                 np.float32(0.875), np.float32(-np.inf), np.bool_(True))
    _assert_heap_close(rN.tree, want.tree)
    with forced_fits([tuple(np.asarray(a) for a in want.tree)],
                     check=False):
        got = stepN(*(shard_array(a, mesh) for a in pools), *args)
    for k in ("H0", "H1", "v0", "v1"):
        np.testing.assert_array_equal(gather(getattr(got, k), mesh).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    for k in ("theta", "p0", "p1", "n0", "n1"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
    np.testing.assert_allclose(_np(got.loss), np.asarray(want.loss),
                               rtol=1e-6)


def _assert_models_equal(tm, want, tl, wl):
    """Stages, thetas and learner statistics bitwise, losses within 1e-6
    (``want`` a port model, or JAX's with its stage dicts)."""
    assert len(tm) == len(want)
    for (ts, tt), (ws, wt_) in zip(tm, want):
        ws = ws.to_stage_dict() if hasattr(ws, "to_stage_dict") else ws
        for k in ws:
            np.testing.assert_array_equal(ts[k], ws[k], err_msg=k)
        assert tt == wt_
    assert [r[:2] for r in tl.history] == [r[:2] for r in wl.history]
    np.testing.assert_allclose(tl.losses, wl.losses, rtol=1e-6)


def _recording_steps(trees):
    """JAX's make_train_step wrapped so that each stage's tree is kept."""
    real_make = jtrainer.make_train_step

    def recording(**kwargs):
        step = real_make(**kwargs)

        def rec(*args):
            res = step(*args)
            trees.append(tuple(np.asarray(a) for a in res.tree))
            return res
        return rec
    return real_make, recording


def _port_train(mesh, trees=None):
    """The port's side of the run below: wt.train over ``mesh``, or with
    None the unsharded train_sharded; teacher-forced with JAX's ``trees``
    when given."""
    model = wt.Model((12, 12, 4), TRAIN_OPTS, device="cpu")
    learner = wt.Learner(alpha=0.2, max_depth=2)
    with (forced_fits(trees) if trees else contextlib.nullcontext()):
        if mesh is None:
            ttrainer.train_sharded(model, tgen(seed=13), learner=learner,
                                   length=8, min_tp=120, min_fp=120, seed=3)
        else:
            wt.train(model, tgen(seed=13), length=8, mesh=mesh,
                     learner=learner,
                     pool=wt.SamplePool(min_tp=120, min_fp=120, seed=3))
    return model, learner


@pytest.fixture(scope="module")
def train_runs():
    """tests/test_parallel.py::test_train_sharded_matches_unsharded's run:
    JAX's wb.train(mesh=make_mesh(8)) with its trees recorded; the port's
    unsharded train_sharded on the same stream, free and teacher-forced
    (then equal to JAX's)."""
    trees = []
    real_make, recording = _recording_steps(trees)
    jm = wb.Model((12, 12, 4), TRAIN_OPTS)
    jl = wb.Learner(alpha=0.2, max_depth=2)
    jtrainer.make_train_step = recording
    try:
        wb.train(jm, jgen(seed=13), length=8, mesh=jax_mesh(8), learner=jl,
                 pool=wb.SamplePool(min_tp=120, min_fp=120, seed=3))
    finally:
        jtrainer.make_train_step = real_make
    assert len(trees) == 8
    forced = _port_train(None, trees)
    _assert_models_equal(forced[0], jm, forced[1], jl)
    return trees, _port_train(None), forced


@pytest.mark.parametrize("n", NS)
def test_train_sharded_matches_unsharded(train_runs, n):
    """wt.train(mesh=n shards), 8 stages: the unsharded run's model,
    thetas and statistics bitwise, losses too; at 8 shards also
    teacher-forced with the trees of JAX's 8-device run."""
    trees, (m1, l1), (mf, lf) = train_runs
    model, learner = _port_train(cpu_mesh(n))
    _assert_models_equal(model, m1, learner, l1)
    np.testing.assert_array_equal(learner.losses, l1.losses)
    if n == 8:
        model, learner = _port_train(cpu_mesh(n), trees)
        _assert_models_equal(model, mf, learner, lf)
        np.testing.assert_array_equal(learner.losses, lf.losses)


def test_train_sharded_resume_pools_carry_over():
    """train_sharded(mesh=4) with a pools dict: the resumed call keeps the
    same sharded pools and equals the unsharded resumed run; a call over
    another mesh re-bootstraps the pools."""
    runs = []
    for mesh in (None, cpu_mesh(4)):
        gen = tgen(seed=29)
        model = wt.Model((12, 12, 4), TRAIN_OPTS, device="cpu")
        learner = wt.Learner(alpha=0.2, max_depth=2)
        pools = {}
        kw = dict(mesh=mesh, learner=learner, min_tp=100, min_fp=100, seed=1,
                  pools=pools)
        ttrainer.train_sharded(model, gen, length=2, **kw)
        fp0 = pools["fp"]
        ttrainer.train_sharded(model, gen, length=4, **kw)
        assert pools["fp"] is fp0 and len(model) == 4
        runs.append((model, learner, pools, gen))
    (mu, lu, pu, _), (mm, lm, pm, gm) = runs
    _assert_models_equal(mm, mu, lm, lu)
    for k in ("fp", "tp"):
        assert pm[k].count == pu[k].count > 0
        for f in ("x", "H", "v"):
            assert torch.equal(gather(getattr(pm[k], f), pm[k].mesh),
                               getattr(pu[k], f)), (k, f)
    fp0 = pm["fp"]
    ttrainer.train_sharded(mm, gm, mesh=cpu_mesh(2), learner=lm, length=5,
                           min_tp=100, min_fp=100, seed=1, pools=pm)
    assert pm["fp"] is not fp0 and len(pm["fp"].x) == 2 and len(mm) == 5
    mm.detect(next(gm)["image"])
    assert mm.eval_cost < len(mm)


def test_fpga_train_sharded_mesh():
    """fpga.train(mesh=4), tests/test_fpga.py's case: the 1-shard run's
    model bitwise, each stage's splits inside its scheduled banks,
    integer thresholds and 1/32-quantized leaves; teacher-forced with
    JAX's meshed run's trees, its thetas and statistics."""
    trees = []
    real_make, recording = _recording_steps(trees)
    jm = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=2, smooth=0,
                                    channels="grad_hist_4_u1"))
    jtrainer.make_train_step = recording
    try:
        jl = jfpga.train(jm, jgen(seed=5), length=4, max_depth=2,
                         quantizer=32, mesh=jax_mesh(4),
                         pool=wb.SamplePool(min_tp=100, min_fp=100, seed=2))
    finally:
        jtrainer.make_train_step = real_make

    def run(n):
        model = wt.Model((12, 12, 4), dict(shrink=2, n_per_oct=2, smooth=0,
                                           channels="grad_hist_4_u1"),
                         device="cpu")
        learner = wt.fpga.train(model, tgen(seed=5), length=4, max_depth=2,
                                quantizer=32, mesh=cpu_mesh(n),
                                pool=wt.SamplePool(min_tp=100, min_fp=100,
                                                   seed=2))
        return model, learner

    model, learner = run(4)
    m1, l1 = run(1)
    _assert_models_equal(model, m1, learner, l1)
    np.testing.assert_array_equal(learner.losses, l1.losses)
    banks = PixelBanks(model.shape, (2, 2))
    sched = BankScheduler(4)
    for stage, _ in model:
        allowed = [set(banks.bank_pixels(b).tolist())
                   for b in sched.schedule(2)]
        assert np.array_equal(stage["threshold"],
                              np.floor(stage["threshold"]))
        pred = stage["prediction"]
        assert np.array_equal(pred * 32, np.round(pred * 32))
        depth = {0: 0}
        for k, (lf, rt) in enumerate(zip(stage["left"], stage["right"])):
            if lf >= 0:
                depth[int(lf)] = depth[int(rt)] = depth[k] + 1
                flat = int(np.ravel_multi_index(stage["feature"][k],
                                                model.shape))
                assert flat in allowed[depth[k]], (k, depth[k])
    with forced_fits(trees, check=False):
        model, learner = run(4)
    _assert_models_equal(model, jm, learner, jl)


@pytest.mark.parametrize("fpga", [False, True])
def test_device_train_golden_on_cpu_mesh(fpga):
    """chip_smoke.py's phase 8e on a mesh of 4 CPU shards: config 4b's
    train_sharded (6 stages) and fpga.train (2 stages) teacher-forced,
    their pools (gathered), steps and models bitwise the goldens'."""
    g = np.load(DEVICE_FPGA_TRAIN_GOLDEN if fpga else DEVICE_TRAIN_GOLDEN)
    model, _ = device_train_golden_run(wt, torch.device("cpu"), g, fpga=fpga,
                                       mesh=cpu_mesh(4))
    assert len(model) == len(g["theta"])
