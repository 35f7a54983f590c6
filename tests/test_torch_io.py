"""PyTorch port, the native input pipeline on the CPU
(``waldboost_tpu_torch/io.py`` and its own copy of the loader,
``waldboost_tpu_torch/native/loader.cpp``): ``tests/test_io.py``'s nine
cases, each held against the JAX package's function (``waldboost_tpu.io``)
on the same files, with tolerance 0 (images, boxes and ignore flags
equal), and the library's build: into ``waldboost_tpu_torch/_build/``,
named by a hash of the source, nothing written under ``waldboost_tpu/``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import waldboost_tpu as wb
from waldboost_tpu import groundtruth as jgt
from waldboost_tpu import io as wio
from waldboost_tpu.utils import fake_data_generator as jax_fake_data

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import groundtruth as tgt
from waldboost_tpu_torch import io as tio

from test_io import BBGT, write_pgm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    if not tio.native_available():
        pytest.skip("the port's native loader did not build (no g++)")
    return True


def assert_same_boxes(a, b):
    np.testing.assert_array_equal(a.get(), b.get())
    np.testing.assert_array_equal(a.get_field("ignore"),
                                  b.get_field("ignore"))


def test_bbgt_native_matches_python(tmp_path, native):
    p = tmp_path / "a.txt"
    p.write_text(BBGT)
    got = tio.read_bbgt_native(str(p))
    assert_same_boxes(got, tgt.read_bbgt(str(p)))
    assert_same_boxes(got, wio.read_bbgt_native(str(p)))
    assert_same_boxes(got, jgt.read_bbgt(str(p)))
    np.testing.assert_allclose(got.get()[0], [10, 20, 40, 60])


def test_bbgt_native_bad_signature(tmp_path, native):
    p = tmp_path / "bad.txt"
    p.write_text("nonsense\n")
    for read in (tio.read_bbgt_native, wio.read_bbgt_native):
        with pytest.raises(ValueError):
            read(str(p))
    with pytest.raises(IOError):
        tio.read_bbgt_native(str(tmp_path / "missing.txt"))


def test_pnm_decode(tmp_path, native):
    img = np.random.RandomState(0).randint(0, 256, (24, 33)).astype(np.uint8)
    p = tmp_path / "img.pgm"
    write_pgm(str(p), img)
    out = tio.load_pnm_gray(str(p))
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, wio.load_pnm_gray(str(p)))
    # a colour P6 file: the same gray conversion as JAX's decoder
    rgb = np.random.RandomState(1).randint(0, 256, (7, 9, 3)).astype(np.uint8)
    p6 = tmp_path / "img.ppm"
    with open(p6, "wb") as f:
        f.write(b"P6\n9 7\n255\n" + rgb.tobytes())
    np.testing.assert_array_equal(tio.load_pnm_gray(str(p6)),
                                  wio.load_pnm_gray(str(p6)))


def _dataset(tmp_path, n=6, seed=1):
    rng = np.random.RandomState(seed)
    imgs, img_paths, ann_paths = [], [], []
    for i in range(n):
        img = rng.randint(0, 256, (16 + i, 20)).astype(np.uint8)
        imgs.append(img)
        ip, ap = tmp_path / f"im{i}.pgm", tmp_path / f"im{i}.txt"
        write_pgm(str(ip), img)
        ap.write_text(BBGT)
        img_paths.append(str(ip))
        ann_paths.append(str(ap))
    return imgs, img_paths, ann_paths


def test_prefetch_dataset_roundtrip(tmp_path, native):
    imgs, img_paths, ann_paths = _dataset(tmp_path)
    records = {}
    for mod in (tio, wio):
        ds = mod.PrefetchDataset(img_paths, ann_paths, n_threads=3,
                                 queue_cap=4)
        records[mod] = {item["index"]: item for item in ds}
        ds.close()
    seen, ref = records[tio], records[wio]
    assert sorted(seen) == sorted(ref) == list(range(6))
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(seen[i]["image"], img)
        np.testing.assert_array_equal(seen[i]["image"], ref[i]["image"])
        assert len(seen[i]["groundtruth_boxes"]) == 2
        assert_same_boxes(seen[i]["groundtruth_boxes"],
                          ref[i]["groundtruth_boxes"])


def test_prefetch_dataset_feeds_training(tmp_path, native):
    """The loader gives wt.train's record shape (an image and its ground
    truth, none without annotations), as JAX's does; closed, it ends."""
    rng = np.random.RandomState(2)
    img_paths = []
    for i in range(3):
        img = (rng.rand(64, 64) * 255).astype(np.uint8)
        img[20:40, 20:40] = 230  # a bright square
        ip = tmp_path / f"t{i}.pgm"
        write_pgm(str(ip), img)
        img_paths.append(str(ip))
    items = {}
    for mod in (tio, wio):
        ds = mod.PrefetchDataset(img_paths, None, n_threads=2, loop=True)
        items[mod] = [next(ds) for _ in range(4)]
        ds.close()
        assert next(ds, None) is None
    for a, b in zip(*(sorted(items[m], key=lambda r: r["index"])[:1]
                      for m in (tio, wio))):
        assert a["image"].shape == (64, 64)
        np.testing.assert_array_equal(a["image"], b["image"])
        assert len(a["groundtruth_boxes"]) == len(b["groundtruth_boxes"]) \
            == 0


def test_bbgt_dataset_paths(tmp_path, native):
    (tmp_path / "imgs").mkdir()
    (tmp_path / "anns").mkdir()
    for stem in ("x", "y"):
        write_pgm(str(tmp_path / "imgs" / f"{stem}.pgm"),
                  np.zeros((8, 8), np.uint8))
    (tmp_path / "anns" / "x.txt").write_text(BBGT)
    args = (str(tmp_path / "imgs"), str(tmp_path / "anns"))
    ip, ap = tio.bbgt_dataset_paths(*args)
    assert (ip, ap) == wio.bbgt_dataset_paths(*args)
    assert len(ip) == 2 and ap[0].endswith("x.txt") and ap[1] == ""
    with pytest.raises(FileNotFoundError):
        tio.bbgt_training_stream(*args, image_ext=".png")


def _bbgt_dir(tmp_path, n_images=6, seed=4):
    """tests/test_cli.py's dataset pair: PGM frames of
    fake_data_generator and 12-field v3 annotations."""
    from test_cli import _write_bbgt_dataset
    return _write_bbgt_dataset(tmp_path, n_images=n_images, seed=seed)


@pytest.mark.parametrize("prefer_native", [True, False])
def test_bbgt_stream_matches_jax(tmp_path, native, prefer_native):
    """bbgt_training_stream, native (records by index: the threads
    finish out of order) and Python (in order), against JAX's Python
    stream."""
    img_dir, ann_dir = _bbgt_dir(tmp_path)
    ref = list(wio.bbgt_training_stream(img_dir, ann_dir, loop=False,
                                        prefer_native=False))
    stream = tio.bbgt_training_stream(img_dir, ann_dir, loop=False,
                                      prefer_native=prefer_native)
    got = list(stream)
    if prefer_native:
        assert isinstance(stream, tio.PrefetchDataset)
        stream.close()
        got.sort(key=lambda r: r["index"])
    assert [r["index"] for r in got] == [r["index"] for r in ref] \
        == list(range(6))
    assert any(len(r["groundtruth_boxes"]) for r in got)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert_same_boxes(a["groundtruth_boxes"], b["groundtruth_boxes"])


def test_prefetcher_stop_hands_back_records():
    """Prefetcher.stop() returns every pulled-but-unconsumed record in
    order, as JAX's does."""
    for mod in (tio, wio):
        pulled = []

        def gen():
            for i in range(100):
                pulled.append(i)
                yield i

        pf = mod.Prefetcher(gen(), depth=8)
        it = iter(pf)
        consumed = [next(it) for _ in range(5)]
        time.sleep(0.2)  # let the producer fill the queue
        residue = pf.stop()
        assert consumed == [0, 1, 2, 3, 4]
        assert consumed + residue == pulled[:len(consumed) + len(residue)]
        assert len(residue) >= 1


def test_prefetcher_propagates_producer_exception():
    for mod in (tio, wio):
        def gen():
            yield 1
            raise RuntimeError("boom")

        it = iter(mod.Prefetcher(gen(), depth=4))
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="boom"):
            next(it)


def test_train_prefetch_loses_no_records():
    """Two wt.train calls on one generator see every record once: what the
    prefetcher pulled but the stage loop did not consume is banked as a
    contiguous tail of the source and handed to the next call, as in
    JAX's test_train_prefetch_loses_no_records."""
    from waldboost_tpu_torch import _prefetch_residue
    from waldboost_tpu_torch.utils import fake_data_generator

    base = fake_data_generator(seed=7)
    served = []

    def gen():
        for i in range(10_000):
            rec = next(base)
            rec["idx"] = i
            served.append(i)
            yield rec

    def banked_idx(g):
        for src, recs in _prefetch_residue.values():
            if src is g:
                return [r["idx"] for r in recs]
        return []

    g = gen()
    model = wt.Model((12, 12, 4), wb.default_channel_opts, device="cpu")
    pool = wt.SamplePool(min_tp=50, min_fp=100)
    learner = wt.train(model, g, pool=pool, length=1, prefetch=8)
    residue1 = banked_idx(g)
    assert residue1
    assert residue1 == served[len(served) - len(residue1):]
    wt.train(model, g, learner=learner, pool=pool, length=2, prefetch=8)
    residue2 = banked_idx(g)
    assert residue2 == served[len(served) - len(residue2):]
    assert residue2[0] >= residue1[0]
    # the generators are the JAX package's dataset, bitwise
    ref = next(jax_fake_data(seed=7))
    np.testing.assert_array_equal(
        next(wt.utils.fake_data_generator(seed=7))["image"], ref["image"])


def test_native_library_built_in_port_build_dir(native, tmp_path):
    """The port compiles its own copy of the loader into
    waldboost_tpu_torch/_build/ (name hashed on the source) and loads it
    from there.  A fresh process that builds it (into a temporary build
    directory) and loads it opens no file for writing under
    waldboost_tpu/ and passes no path there to a child process (an
    audit hook records both), and imports nothing of the JAX package."""
    path = tio.loader_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "waldboost_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libloader_")
    assert os.path.exists(path)
    assert tio.LOADER_SRC == os.path.join(ROOT, "waldboost_tpu_torch",
                                          "native", "loader.cpp")
    assert os.path.samefile(tio._get_lib()._name, path)

    code = f"""
import os, sys
jax_pkg = os.path.join({ROOT!r}, "waldboost_tpu") + os.sep
bad = []

def hook(event, args):
    if event == "open" and isinstance(args[0], str) and args[1] and \\
            any(c in args[1] for c in "wax+"):
        if os.path.abspath(args[0]).startswith(jax_pkg):
            bad.append(args[0])
    if event == "subprocess.Popen":
        bad.extend(a for a in map(str, args[1])
                   if os.path.abspath(a).startswith(jax_pkg))

sys.addaudithook(hook)
import waldboost_tpu_torch.io as io
io.BUILD_DIR = {str(tmp_path)!r}
assert io.native_available()
assert os.path.dirname(io._get_lib()._name) == {str(tmp_path)!r}
assert io.read_bbgt_native({str(tmp_path / "a.txt")!r}).get().shape == (2, 4)
assert not bad, bad
assert "waldboost_tpu" not in sys.modules
print("ok")
"""
    (tmp_path / "a.txt").write_text(BBGT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert [f for f in os.listdir(tmp_path) if f.startswith("libloader_")]
