"""PyTorch port: kernel S4 (``ops/octaves.py::octaves``,
``csrc/octaves.cu``), the octave chain of a batch and its concatenation
into the (B, S) octave buffer in one launch, held byte for byte against
the plain chain ``octave_buffer(level_octaves(...))`` (uint8 and float32)
on the same tensors.

Run on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_octaves.py -m cuda

Without a card the card tests skip (the check is made in a fixture, so
every pytest worker collects the same tests).  The CPU tests hold the
wrapper's plain route, its argument checks, the closed form of the uint8
step and a numpy model of the kernel's schedule (regions of 64 rows of
256 bytes, edge regions masked, a second launch past seven octaves)
against the plain chain."""

import os

import numpy as np
import pytest
import torch

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import canvas as canvas_mod
from waldboost_tpu_torch._build import launches
from waldboost_tpu_torch.channels import level_octaves
from waldboost_tpu_torch.ops.octaves import (LAUNCH_LEVELS, octave_sizes,
                                             octaves, octaves_plain)
from waldboost_tpu_torch.ops.planes import octave_buffer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "models", "flagship_synth_64.pb")
FPGA_4K = os.path.join(ROOT, "models", "fpga_4k_synth_64.pb")
#: odd and tiny sides, and the benchmark's frames
EDGE_HW = ((1, 1), (3, 5), (17, 45), (97, 131), (135, 240))
F32 = np.float32
#: the rows and bytes a row of the kernel's first-octave region
#: (csrc/octaves.cu kRows, kRowBytes)
REGION_ROWS, REGION_BYTES = 64, 256


def _frames(B, hw, dtype, seed, special=False):
    """(B, H, W) seeded frames: uint8 noise, or float32 values spread over
    many exponents; ``special`` plants NaN, +-inf, subnormals and -0."""
    rng = np.random.RandomState(seed)
    shape = (B,) + tuple(hw)
    if dtype == torch.uint8:
        return torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8))
    x = (rng.standard_normal(shape) * 2.0 ** rng.randint(-20, 20, shape))
    x = x.astype(F32)
    if special:
        pick = rng.randint(0, 12, shape)
        tiny = np.finfo(F32).tiny
        x = np.where(pick == 0, F32(np.nan), x)
        x = np.where(pick == 1, F32(np.inf), x)
        x = np.where(pick == 2, F32(-np.inf), x)
        x = np.where(pick == 3, (rng.randint(1, 2 ** 23, shape)
                                 .astype(np.int32).view(F32)
                                 * rng.choice([-1, 1], shape)), x)
        x = np.where(pick == 4, F32(-0.0), x)
        x = np.where(pick == 5, F32(tiny), x)
        x = x.astype(F32)
    return torch.from_numpy(np.ascontiguousarray(x))


def _plain(images, n):
    return octave_buffer(level_octaves(images, n))


def _same_bits(a, b):
    """Byte for byte: float32 compared as its bits."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


# -- on the CPU -----------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("hw", EDGE_HW)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_cpu_wrapper_is_the_plain_chain(dtype, B, hw, n):
    images = _frames(B, hw, dtype, seed=B * 1000 + hw[0] * 7 + n,
                     special=True)
    before = launches["octaves"]
    got = octaves(images, n)
    want = _plain(images, n)
    assert launches["octaves"] == before
    assert got.dtype == dtype
    S = sum(h * w for h, w in octave_sizes(*hw, n))
    assert tuple(got.shape) == (B, S)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    out = torch.full((B, S), 7, dtype=dtype)
    assert octaves(images, n, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("hw", EDGE_HW)
def test_octave_sizes_are_the_chain_shapes(hw):
    images = _frames(1, hw, torch.uint8, seed=3)
    chain = level_octaves(images, 8)
    assert octave_sizes(*hw, 8) == [tuple(o.shape[1:]) for o in chain]


def _wrapped_step(a, b, c, d):
    """The plain chain's uint8 step: the row pair wraps, the column pair
    wraps, then the floor of a quarter."""
    a, b, c, d = (np.asarray(v, np.int64) for v in (a, b, c, d))
    return (((a + b) % 256 + (c + d) % 256) % 256) // 4


def _closed_form(a, b, c, d):
    a, b, c, d = (np.asarray(v, np.uint32) for v in (a, b, c, d))
    return ((a + b + c + d) & 255) >> 2


@pytest.mark.parametrize("kind", ["zeros", "max", "sample"])
def test_closed_form_is_the_wrapped_step(kind):
    """``((tl + bl + tr + br) & 255) >> 2`` (S4's uint8 step) equals the
    chain's two wrapped pair sums and floor on all 0, all 255 and 10^6
    seeded quads; and the chain on 2x2 frames of those quads gives it."""
    if kind == "zeros":
        quads = np.zeros((4, 1), np.uint8)
    elif kind == "max":
        quads = np.full((4, 1), 255, np.uint8)
    else:
        quads = np.random.RandomState(24).randint(0, 256, (4, 10 ** 6),
                                                  dtype=np.uint8)
    want = _wrapped_step(*quads)
    got = _closed_form(*quads)
    np.testing.assert_array_equal(got, want)
    # tl, bl, tr, br as the chain's 2x2 blocks
    frames = np.empty((quads.shape[1], 2, 2), np.uint8)
    frames[:, 0, 0], frames[:, 1, 0] = quads[0], quads[1]
    frames[:, 0, 1], frames[:, 1, 1] = quads[2], quads[3]
    chain = level_octaves(torch.from_numpy(frames), 2)[1]
    np.testing.assert_array_equal(chain.numpy().reshape(-1), want)


def _pool(x):
    """S4's 2x2 step on a numpy tile: the closed form (uint8) or
    ``(((tl + bl) + tr) + br) * 0.25`` in float32."""
    tl, bl = x[0::2, 0::2], x[1::2, 0::2]
    tr, br = x[0::2, 1::2], x[1::2, 1::2]
    if x.dtype == np.uint8:
        return _closed_form(tl, bl, tr, br).astype(np.uint8)
    with np.errstate(invalid="ignore", over="ignore"):
        return ((((tl + bl) + tr) + br) * F32(0.25)).astype(F32)


def _kernel_model(images, n):
    """S4's schedule in numpy: launches of ``LAUNCH_LEVELS`` octaves, each
    after the first starting from the last octave the one before it wrote;
    per frame and region of 64 rows of 256 bytes of the launch's first
    octave, that region (zeros outside the frame) halved in place, each
    octave's pixels inside its sides written, octave k's part of the
    region skipped with the rest once it lies outside.  Returns the buffer
    and how often each value was written."""
    B, H, W = images.shape
    sizes = octave_sizes(H, W, n)
    offs = np.concatenate([[0], np.cumsum([h * w for h, w in sizes])])
    out = np.zeros((B, int(offs[-1])), images.numpy().dtype)
    writes = np.zeros(out.shape, np.int64)
    src, start = images.numpy(), 0
    th, tw = REGION_ROWS, REGION_BYTES // out.itemsize
    while B:
        stop = min(start + LAUNCH_LEVELS, n)
        (h0, w0), levels = sizes[start], sizes[start:stop]
        if h0 * w0 == 0:
            break
        for b in range(B):
            for ty in range(-(-h0 // th)):
                for tx in range(-(-w0 // tw)):
                    tile = np.zeros((th, tw), out.dtype)
                    part = src[b, ty * th:(ty + 1) * th,
                               tx * tw:(tx + 1) * tw]
                    tile[:part.shape[0], :part.shape[1]] = part
                    for k, (hk, wk) in enumerate(levels):
                        mh, mw = th >> k, tw >> k
                        if k:
                            tile = _pool(tile)
                        y, x = ty * mh, tx * mw
                        if y >= hk or x >= wk:
                            break
                        if k == 0 and start > 0:
                            continue
                        rows, cols = min(mh, hk - y), min(mw, wk - x)
                        at = offs[start + k] + (y + np.arange(rows))[:, None] \
                            * wk + x + np.arange(cols)
                        out[b, at] = tile[:rows, :cols]
                        writes[b, at] += 1
        if stop == n:
            break
        start = stop - 1
        h, w = sizes[start]
        src = out[:, offs[start]:offs[start] + h * w].reshape(B, h, w)
    return out, writes


@pytest.mark.parametrize("n", [1, 5, 7, 8, 9, 14])
@pytest.mark.parametrize("hw", [(1, 1), (17, 45), (135, 240), (300, 517)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_kernel_schedule_is_the_plain_chain(dtype, hw, n):
    """The tiles, masks and launches of S4, modelled in numpy, write every
    value of the buffer once and give the plain chain, octaves past the
    seventh included (300x517 has nine non-empty octaves)."""
    images = _frames(2, hw, dtype, seed=hw[1] + n, special=True)
    got, writes = _kernel_model(images, n)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(got, _plain(images, n).numpy())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ok = torch.zeros(2, 8, 8, dtype=torch.uint8)
    bad_images = (torch.zeros(2, 8, 8, dtype=torch.int16),
                  torch.zeros(2, 8, 8, dtype=torch.float64),
                  torch.zeros(2, 8, 8, dtype=torch.bfloat16),
                  torch.zeros(8, 8, dtype=torch.uint8),
                  torch.zeros(1, 2, 8, 8, dtype=torch.uint8),
                  torch.zeros(2, 8, 16, dtype=torch.uint8)[:, :, ::2],
                  np.zeros((2, 8, 8), np.uint8))
    for images in bad_images:
        with pytest.raises(ValueError):
            octaves(images, 3)
        with pytest.raises(ValueError):
            octaves_plain(images, 3)
    for n in (0, -1, 1.5, "3", True, None):
        with pytest.raises(ValueError):
            octaves(ok, n)
    S = sum(h * w for h, w in octave_sizes(8, 8, 3))
    for out in (torch.zeros(2, S, dtype=torch.float32),
                torch.zeros(2, S + 1, dtype=torch.uint8),
                torch.zeros(3, S, dtype=torch.uint8),
                torch.zeros(2, 2 * S, dtype=torch.uint8)[:, ::2],
                torch.zeros(2, S, dtype=torch.uint8, device="meta"),
                np.zeros((2, S), np.uint8)):
        with pytest.raises(ValueError):
            octaves(ok, 3, out=out)
    with pytest.raises(ValueError):
        octaves(ok.to("meta"), 3)


def test_canvas_on_the_cpu_takes_the_plain_chain():
    """A CPU canvas's octave buffer is the plain chain's, with no launch;
    a non-contiguous batch is served as before."""
    model = wt.load(FLAGSHIP, device="cpu")
    fn, _ = wt.make_batched_detector_boxes(model, (96, 128), k=64,
                                           device="cpu")
    canvas = fn.canvas
    wide = _frames(2, (96, 256), torch.uint8, seed=9)
    images = wide[:, :, ::2]
    before = launches["octaves"]
    got = canvas.octaves(images)
    assert launches["octaves"] == before
    assert torch.equal(got, _plain(images.contiguous(), canvas.n_octaves))


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _launches_for(hw, n):
    """S4's launches for a frame of sides ``hw`` and ``n`` octaves: one,
    and one more for each further six whose first octave is not empty."""
    sizes = octave_sizes(*hw, n)
    starts = range(0, max(n - 1, 1), LAUNCH_LEVELS - 1)
    return sum(1 for s in starts if sizes[s][0] * sizes[s][1] > 0)


CARD_CASES = ([((480, 640), 5, B) for B in (1, 3, 8)]
              + [((2160, 3840), 7, B) for B in (1, 8)]
              + [(hw, n, B) for hw in EDGE_HW for n in (1, 2, 5, 7, 8)
                 for B in (1, 3)]
              + [((300, 517), n, B) for n in (8, 9, 14) for B in (1, 3, 8)]
              + [((1031, 2050), 11, 3), ((2160, 3840), 12, 1)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("hw,n,B", CARD_CASES)
def test_kernel_is_the_plain_chain(cuda, hw, n, B, dtype):
    """S4 byte for byte the plain chain on the same CUDA tensors (float32
    frames with NaN, +-inf, subnormals and -0), into a fresh buffer and
    into one filled with another value first, with one launch and one
    more for each further six octaves."""
    images = _frames(B, hw, dtype, seed=hw[0] * 31 + n * 7 + B,
                     special=True).to(cuda)
    want = _plain(images, n)
    before = launches["octaves"]
    got = octaves(images, n)
    torch.cuda.synchronize()
    assert launches["octaves"] - before == _launches_for(hw, n)
    assert _same_bits(got, want)
    out = torch.full_like(want, 0xAB if dtype == torch.uint8 else 3.5)
    assert octaves(images, n, out=out) is out
    torch.cuda.synchronize()
    assert _same_bits(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shift_frames", [False, True])
@pytest.mark.parametrize("offset", [1, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_kernel_reads_and_writes_off_alignment(cuda, dtype, offset,
                                               shift_frames):
    """A buffer that starts ``offset`` values past 16 bytes (octave 0's
    aligned windows shifted by any number of bytes, their narrow first and
    last bytes), from aligned frames and from frames shifted alike
    (value-by-value loads and stores)."""
    B, hw, n = 3, (130, 192), 6
    images = _frames(B, hw, dtype, seed=offset, special=True).to(cuda)
    flat = torch.empty(B * hw[0] * hw[1] + offset, dtype=dtype, device=cuda)
    shifted = flat[offset:].view(B, *hw) if shift_frames \
        else flat[:-offset].view(B, *hw)
    shifted.copy_(images)
    want = _plain(images, n)
    room = torch.empty(want.numel() + offset, dtype=dtype, device=cuda)
    out = room[offset:].view(want.shape)
    assert octaves(shifted, n, out=out) is out
    torch.cuda.synchronize()
    assert _same_bits(out, want)


@pytest.mark.cuda
def test_kernel_refuses_on_the_card(cuda):
    images = torch.zeros(2, 16, 32, dtype=torch.uint8, device=cuda)
    for bad in (images[:, :, ::2], images.double(), images[0]):
        with pytest.raises(ValueError):
            octaves(bad, 3)
    with pytest.raises(ValueError):
        octaves(images, 3, out=torch.empty(2, 5, dtype=torch.uint8,
                                           device=cuda))
    with pytest.raises(ValueError):
        octaves(images, 3, out=torch.empty(2, 16 * 32 + 8 * 16 + 4 * 8,
                                           dtype=torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw", [(0, (16, 16)), (2, (0, 16)), (2, (16, 0))])
def test_empty_batch_makes_no_launch(cuda, B, hw):
    images = torch.zeros((B,) + hw, dtype=torch.uint8, device=cuda)
    before = launches["octaves"]
    got = octaves(images, 4)
    assert launches["octaves"] == before
    S = sum(h * w for h, w in octave_sizes(*hw, 4))
    assert tuple(got.shape) == (B, S)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["vga", "4k"])
def test_dense_call_launches_s4_once(cuda, path, monkeypatch):
    """A dense call at the benchmark's sizes launches S4 once, and its
    outputs are bitwise those of the same call with the plain chain in
    S4's place."""
    model_path, hw, k = {"vga": (FLAGSHIP, (480, 640), 1024),
                         "4k": (FPGA_4K, (2160, 3840), 128)}[path]
    model = wt.load(model_path, device=cuda)
    fn, _ = wt.make_batched_detector_boxes(model, hw, k=k, nms_iou=0.5,
                                           device=cuda)
    images = _frames(8, hw, torch.uint8, seed=24).to(cuda)
    fn(images)  # tables and kernels set up
    before = launches["octaves"]
    got = fn(images)
    torch.cuda.synchronize()
    assert launches["octaves"] - before == 1
    monkeypatch.setattr(canvas_mod, "octave_buffer_of", octaves_plain)
    plain = fn(images)
    assert launches["octaves"] - before == 1
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
