"""The host input pipeline: record prefetching and the native loader.

The port's own copy of ``waldboost_tpu/io/__init__.py``:
``prefetch_iterable`` and ``Prefetcher`` (pure Python threading: a
producer thread decodes records while the device computes, in source
order), and the native half: a C++ library (the port's copy of the
loader source, ``native/loader.cpp``) that parses bbGt files, decodes
PNM images and runs a threaded prefetching dataset
(:class:`PrefetchDataset`), with Python fallbacks (the port's
``groundtruth.read_bbgt`` and PIL) where the library cannot be built.

The library is compiled with g++ at its first use into
``waldboost_tpu_torch/_build/``, its file name carrying a hash of the
source; a failed build is logged and leaves :func:`native_available`
False.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import queue
import subprocess
import tempfile
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from .boxes import Boxes

logger = logging.getLogger(__name__)

__all__ = ["native_available", "read_bbgt_native", "load_pnm_gray",
           "PrefetchDataset", "bbgt_dataset_paths", "bbgt_training_stream",
           "prefetch_iterable", "Prefetcher"]


def prefetch_iterable(iterable, depth: int = 16):
    """Yield the records of ``iterable`` in order while a daemon thread
    drains it into a queue ``depth`` records deep; an exception of the
    producer is raised at the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
    END = object()

    def worker():
        try:
            for item in iterable:
                q.put(item)
            q.put(END)
        except BaseException as e:  # handed to the consumer, raised there
            q.put((END, e))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is END:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is END:
            raise item[1]
        yield item


class Prefetcher:
    """A stoppable :func:`prefetch_iterable`: :meth:`stop` joins the
    producer and returns every record it pulled from the source that was
    not consumed, in order, so a later reader of the same source loses
    none."""

    _END = object()

    def __init__(self, iterable, depth: int = 16):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._halt = threading.Event()
        self._overflow: list = []   # the record in flight when stop came
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(iterable,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Put ``item``, polling the halt flag; False if halted first."""
        while not self._halt.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, iterable) -> None:
        try:
            for item in iterable:
                if not self._put(item):
                    self._overflow.append(item)
                    return
        except BaseException as e:  # handed to the consumer, raised there
            self._exc = e
        # the sentinel unblocks the consumer; stop() drops it
        self._put(self._END)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                if self._exc is not None:
                    exc, self._exc = self._exc, None
                    raise exc
                return
            yield item

    def stop(self) -> list:
        """Halt the producer; return the unconsumed records in order."""
        self._halt.set()
        self._thread.join()
        residue = []
        while not self._q.empty():
            item = self._q.get_nowait()
            if item is not self._END:
                residue.append(item)
        residue.extend(self._overflow)
        self._overflow = []
        return residue


_HERE = os.path.dirname(os.path.abspath(__file__))
LOADER_SRC = os.path.join(_HERE, "native", "loader.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

#: the most boxes one annotation file may give (larger counts are cut)
MAX_BOXES = 4096


def loader_path() -> str:
    """Where the library of the current ``native/loader.cpp`` lives: a
    file in ``_build/`` named by a hash of the source and the flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(LOADER_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libloader_{digest.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    """Compile the loader into ``lib`` (through a temporary file, so
    concurrent builders never load a half-written library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, LOADER_SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native loader build failed: %s", e)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=1)
def _get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first when missing; None (logged) when
    it cannot be built or loaded."""
    lib_path = loader_path()
    if not os.path.exists(lib_path) and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as e:
        logger.warning("native loader load failed: %s", e)
        return None
    lib.wb_bbgt_parse_file.restype = ctypes.c_int
    lib.wb_bbgt_parse_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.wb_load_pnm_gray.restype = ctypes.c_int
    lib.wb_load_pnm_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.wb_prefetcher_create.restype = ctypes.c_void_p
    lib.wb_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.wb_prefetcher_next.restype = ctypes.c_int
    lib.wb_prefetcher_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64)]
    lib.wb_prefetcher_destroy.restype = None
    lib.wb_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_available() -> bool:
    """Whether the C++ loader is built (building it at the first call)."""
    return _get_lib() is not None


def read_bbgt_native(filename: str, cap: int = MAX_BOXES) -> Boxes:
    """Ground truth of a bbGt v3 file by the C++ parser: XYXY boxes with
    an 'ignore' field (the port's ``groundtruth.read_bbgt`` without the
    library).  Raises IOError when the file cannot be read and
    ValueError when it is not a bbGt v3 file."""
    lib = _get_lib()
    if lib is None:
        from .groundtruth import read_bbgt
        return read_bbgt(filename)
    rects = np.zeros((cap, 4), np.float32)
    ignore = np.zeros(cap, np.int32)
    n = lib.wb_bbgt_parse_file(filename.encode(), _ptr(rects, ctypes.c_float),
                               _ptr(ignore, ctypes.c_int), cap)
    if n == -1:
        raise IOError(f"cannot read {filename}")
    if n < 0:
        raise ValueError(f"invalid bbGt file {filename} (code {n})")
    n = min(n, cap)
    return Boxes(rects[:n], ignore=ignore[:n].copy())


def load_pnm_gray(filename: str, max_pixels: int = 1 << 24) -> np.ndarray:
    """A P5/P6 PNM file as an (H, W) uint8 gray image by the C++ decoder
    (PIL's "L" conversion without the library)."""
    lib = _get_lib()
    if lib is None:
        from PIL import Image
        return np.asarray(Image.open(filename).convert("L"))
    buf = np.zeros(max_pixels, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.wb_load_pnm_gray(filename.encode(), _ptr(buf, ctypes.c_uint8),
                              max_pixels, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"cannot decode {filename} (code {rc})")
    return buf[:h.value * w.value].reshape(h.value, w.value).copy()


def bbgt_dataset_paths(image_dir: str, annotation_dir: str,
                       image_ext: str = ".pgm", ann_ext: str = ".txt"):
    """``(image paths, annotation paths)``: the images of ``image_dir``
    with extension ``image_ext`` in name order, each paired with its
    same-stem annotation file in ``annotation_dir`` ("" when none)."""
    imgs = sorted(f for f in os.listdir(image_dir) if f.endswith(image_ext))
    img_paths, ann_paths = [], []
    for f in imgs:
        ann = os.path.join(annotation_dir, os.path.splitext(f)[0] + ann_ext)
        img_paths.append(os.path.join(image_dir, f))
        ann_paths.append(ann if os.path.exists(ann) else "")
    return img_paths, ann_paths


class PrefetchDataset:
    """Iterator of ``{"image", "groundtruth_boxes", "index"}`` dicts
    decoded by C++ worker threads into a bounded queue (``queue_cap``
    records), in the order the threads finish; ``index`` is the record's
    position in ``img_paths``.  ``loop`` cycles the paths forever.
    :meth:`close` stops the threads.  A source for
    :func:`waldboost_tpu_torch.train`."""

    def __init__(self, img_paths: Sequence[str],
                 ann_paths: Optional[Sequence[str]] = None,
                 n_threads: int = 4, queue_cap: int = 16, loop: bool = False,
                 max_pixels: int = 1 << 24):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (g++ build failed)")
        self._lib = lib
        n = len(img_paths)
        # the path bytes and the arrays of pointers to them live as long
        # as the loader, which reads them from its threads
        self._img_paths = [p.encode() for p in img_paths]
        self._img_arr = (ctypes.c_char_p * n)(*self._img_paths)
        self._ann_arr = None
        if ann_paths is not None:
            self._ann_paths = [p.encode() if p else b"" for p in ann_paths]
            self._ann_arr = (ctypes.c_char_p * n)(*self._ann_paths)
        self._handle = lib.wb_prefetcher_create(
            self._img_arr, self._ann_arr, n, n_threads, queue_cap,
            1 if loop else 0)
        self._max_pixels = max_pixels
        self._img_buf = np.zeros(max_pixels, np.uint8)
        self._rects_buf = np.zeros((MAX_BOXES, 4), np.float32)
        self._ignore_buf = np.zeros(MAX_BOXES, np.int32)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._handle is None:
            raise StopIteration
        h, w = ctypes.c_int(), ctypes.c_int()
        n_rects, index = ctypes.c_int(), ctypes.c_int64()
        rc = self._lib.wb_prefetcher_next(
            self._handle, _ptr(self._img_buf, ctypes.c_uint8),
            self._max_pixels, ctypes.byref(h), ctypes.byref(w),
            _ptr(self._rects_buf, ctypes.c_float), MAX_BOXES,
            ctypes.byref(n_rects), _ptr(self._ignore_buf, ctypes.c_int),
            ctypes.byref(index))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError(f"decode failed for item {index.value} (code {rc})")
        image = self._img_buf[:h.value * w.value].reshape(
            h.value, w.value).copy()
        nb = n_rects.value
        gt = Boxes(self._rects_buf[:nb].copy(),
                   ignore=self._ignore_buf[:nb].copy())
        return dict(image=image, groundtruth_boxes=gt, index=index.value)

    def close(self) -> None:
        """Stop and join the worker threads (idempotent)."""
        if getattr(self, "_handle", None) is not None:
            self._lib.wb_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def bbgt_training_stream(image_dir: str, annotation_dir: str,
                         image_ext: str = ".pgm", ann_ext: str = ".txt",
                         loop: bool = True, prefer_native: bool = True,
                         n_threads: int = 4, queue_cap: int = 16):
    """Training records ``{"image", "groundtruth_boxes", "index"}`` of a
    bbGt-style dataset (images in ``image_dir``, same-stem annotations in
    ``annotation_dir``): a :class:`PrefetchDataset` when the library is
    built and ``prefer_native``, else a Python generator decoding in order
    through :func:`load_pnm_gray` and :func:`read_bbgt_native`'s
    fallbacks.  ``loop`` cycles the dataset forever.  Raises
    FileNotFoundError when ``image_dir`` holds no ``image_ext`` image."""
    img_paths, ann_paths = bbgt_dataset_paths(image_dir, annotation_dir,
                                              image_ext, ann_ext)
    if not img_paths:
        raise FileNotFoundError(
            f"no '{image_ext}' images found in {image_dir!r}")
    if prefer_native and native_available():
        return PrefetchDataset(img_paths, ann_paths, n_threads=n_threads,
                               queue_cap=queue_cap, loop=loop)

    def records():
        while True:
            for i, (ip, ap) in enumerate(zip(img_paths, ann_paths)):
                gt = read_bbgt_native(ap) if ap else Boxes(
                    np.zeros((0, 4), np.float32),
                    ignore=np.zeros(0, np.int32))
                yield dict(image=load_pnm_gray(ip), groundtruth_boxes=gt,
                           index=i)
            if not loop:
                return

    return records()
