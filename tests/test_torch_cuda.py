"""PyTorch port on the card: each CUDA kernel bitwise against its plain
version on the same CUDA tensors, and the whole slice on the card against
the plain path on the CPU and the committed JAX golden detections.

Run on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda

Without a card every test here skips (the check is made in a fixture, so
every pytest worker collects the same tests)."""

import os
import sys

import numpy as np
import pytest
import torch

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import packing, polyphase
from waldboost_tpu_torch._build import launches
from waldboost_tpu_torch.canvas import channel_canvas, window_grid
from waldboost_tpu_torch.ops import cascade as tc
from waldboost_tpu_torch.ops import cascade_static as tcs
from waldboost_tpu_torch.ops import channels as tcc
from waldboost_tpu_torch.ops import fpga as tfp
from waldboost_tpu_torch.ops import planes as tpl

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "models", "flagship_synth_64.pb")
HARD256 = os.path.join(ROOT, "models", "flagship_hard_256.pb")
HARD64 = os.path.join(ROOT, "models", "flagship_hard_64.pb")

sys.path.insert(0, ROOT)
from chip_smoke import (CANVAS_GOLDEN,  # noqa: E402
                        DEVICE_FPGA_TRAIN_GOLDEN, DEVICE_TRAIN_GOLDEN,
                        b3f_edges,
                        FPGA_TRAIN_GOLDEN, TRAIN_DEPTH, TRAIN_GOLDEN,
                        canvas_golden_frames, canvas_golden_run,
                        canvas_model_path, device_train_golden_run,
                        dropout_off, fpga_train_golden_run, full_f32,
                        golden_verifier,
                        precision_probe, random_deep_stage, tf32_probe,
                        train_golden_run, tree_diff, verifier_golden_run,
                        verifier_pools, VTRAIN_PARAM_TOL)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _frames(n, hw, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (n,) + hw).astype(np.uint8))


@pytest.mark.parametrize("hw,npo", [((48, 64), 2), ((480, 640), 8)])
def test_kernels_match_plain_on_card(cuda, hw, npo):
    h, w = hw
    model = wt.load(FLAGSHIP)
    packed = packing._packed_plan_cached(h, w, 2, npo, (12, 12), halo=1)
    tables = polyphase.plane_tables(packed, packed.halo, hw)
    pops = tpl.PlaneOperands.build(tables, cuda)
    imgs = _frames(3, hw, seed=1).to(cuda)
    octs = tpl.octave_buffer(tch.level_octaves(imgs, len(tables.oct_hw)))
    planes = tpl.planes(octs, pops)
    torch.testing.assert_close(planes, tpl.planes_plain(octs, pops),
                               rtol=0, atol=0)
    mask = torch.as_tensor(packed.smooth_interior_mask().astype(np.uint8),
                           device=cuda)
    for smooth in (0, 1):
        got = tcc.grad_hist(planes, mask if smooth else None, smooth)
        want = tcc.grad_hist_plain(planes, mask if smooth else None, smooth)
        assert torch.equal(got, want)
    canvas = tcc.grad_hist(planes, mask, 1)
    valid = torch.as_tensor(packed.valid_mask((12, 12)).astype(np.uint8),
                            device=cuda)
    cops = tcs.CascadeOperands.build(tcs.static_cascade_from_model(model),
                                     (12, 12), 4, cuda)
    got = tcs.cascade_masked(canvas, valid, cops)
    want = tcs.cascade_masked_plain(canvas, valid, cops)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("hw", [(37, 45), (64, 96)])
def test_grad_hist_any_mask_on_card(cuda, hw):
    # a mask set on the canvas border: the smooth reads the pooled ring
    # outside the canvas, which both versions take as 0; and a random mask
    rng = np.random.RandomState(3)
    planes = torch.from_numpy(rng.randint(0, 256, (2, 2, 2) + hw)
                              .astype(np.uint8)).to(cuda)
    mask = torch.ones(hw, dtype=torch.uint8, device=cuda)
    got = tcc.grad_hist(planes, mask, 1)
    want = tcc.grad_hist_plain(planes, mask, 1)
    assert torch.equal(got, want)
    mask = torch.from_numpy((rng.rand(*hw) < 0.7).astype(np.uint8)).to(cuda)
    assert torch.equal(tcc.grad_hist(planes, mask, 1),
                       tcc.grad_hist_plain(planes, mask, 1))


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (17, 45), (33, 131),
                                (14, 128), (16, 128), (70, 257)])
@pytest.mark.parametrize("batch", [1, 3])
def test_grad_hist_tiling_edges_on_card(cuda, hw, batch):
    """B2 at heights and widths that are no multiple of its 128 x 16 (14)
    tile or of the 4-pixel vector, both smooths, a random mask, with the
    planes and mask also starting one byte past a word boundary."""
    rng = np.random.RandomState(hw[0] * 1000 + hw[1] + batch)
    planes = torch.from_numpy(rng.randint(0, 256, (batch, 2, 2) + hw)
                              .astype(np.uint8)).to(cuda)
    mask = torch.from_numpy((rng.rand(*hw) < 0.9).astype(np.uint8)).to(cuda)
    for smooth in (0, 1):
        m = mask if smooth else None
        want = tcc.grad_hist_plain(planes, m, smooth)
        got = tcc.grad_hist(planes, m, smooth)
        odd = tcc.grad_hist(_misaligned(planes),
                            _misaligned(mask) if smooth else None, smooth)
        torch.cuda.synchronize()
        assert torch.equal(got, want), smooth
        assert torch.equal(odd, want), smooth


@pytest.mark.parametrize("hw", [(18, 18), (19, 27), (31, 45), (48, 64),
                                (61, 95), (97, 131)])
@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("batch", [1, 3])
def test_planes_every_byte_on_card(cuda, hw, halo, batch):
    """B1 from the smallest frame that plans a level to 97 x 131, odd
    widths, baked halo 0 and 2, into an output buffer pre-filled with
    0xAB (whole, and starting one byte past a word boundary): equal to the
    plain version, gap bytes included."""
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, 2, (8, 8),
                                         halo=halo)
    tables = polyphase.plane_tables(packed, packed.halo, hw)
    pops = tpl.PlaneOperands.build(tables, cuda)
    imgs = _frames(batch, hw, seed=hw[0] + halo).to(cuda)
    octs = tpl.octave_buffer(tch.level_octaves(imgs, len(tables.oct_hw)))
    want = tpl.planes_plain(octs, pops)
    shape = (batch, 2, 2) + tables.plane_hw
    out = torch.full(shape, 0xAB, dtype=torch.uint8, device=cuda)
    assert tpl.planes(octs, pops, out=out).data_ptr() == out.data_ptr()
    odd = _misaligned(torch.full(shape, 0xAB, dtype=torch.uint8,
                                 device=cuda))
    tpl.planes(octs, pops, out=odd)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(odd, want)


FPGA_KINDS = ("grad_hist_4_u1", "grad_mag_u1", "grad_hist_4_u1+grad_mag_u1",
              "grad_mag_u1+grad_hist_4_u1")


@pytest.mark.parametrize("hw", [(96, 128), (480, 640)])
def test_fpga_kernel_matches_plain_on_card(cuda, hw):
    """B5 bitwise against its plain version on the planes and masks of a
    real halo-0 plan, every kind and smooth."""
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, 4, (12, 12),
                                         halo=0)
    imgs = _frames(3, hw, seed=6).to(cuda)
    for kind in FPGA_KINDS:
        for smooth in (0, 1):
            step = channel_canvas(packed, hw, smooth,
                                  tch.resolve_channel_function(kind), cuda)
            planes = step.planes(step.octaves(imgs))
            got = tfp.fpga_channels(planes, step.ring, step.interior, kind,
                                    smooth)
            want = tfp.fpga_channels_plain(planes, step.ring, step.interior,
                                           kind, smooth)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kind, smooth)


@pytest.mark.parametrize("hw", [(37, 45), (64, 96)])
def test_fpga_any_mask_on_card(cuda, hw):
    # random masks reaching the canvas border: the Sobel and the smooth
    # read zeros outside the canvas in both versions
    rng = np.random.RandomState(7)
    planes = torch.from_numpy(rng.randint(0, 256, (2, 2, 2) + hw)
                              .astype(np.uint8)).to(cuda)
    ring = torch.from_numpy((rng.rand(2, 2, *hw) < 0.8).astype(np.uint8)) \
        .to(cuda)
    interior = torch.ones(hw, dtype=torch.uint8, device=cuda)
    for kind in FPGA_KINDS:
        for smooth in (0, 1):
            mask = interior if smooth else None
            got = tfp.fpga_channels(planes, ring, mask, kind, smooth)
            want = tfp.fpga_channels_plain(planes, ring, mask, kind, smooth)
            assert torch.equal(got, want), (kind, smooth)


def _misaligned(t: torch.Tensor, elems: int = 1) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts ``elems`` elements
    past an aligned address (one byte for uint8)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (17, 45), (33, 131),
                                (16, 128), (70, 257)])
@pytest.mark.parametrize("batch", [1, 3])
def test_fpga_tiling_edges_on_card(cuda, hw, batch):
    """B5 at widths and heights that are no multiple of the 128 x 16 tile
    or of the 4-pixel vector, narrow levels included, at C = 1, 4 and 5,
    both smooths, with the planes and masks also starting off a word
    boundary."""
    rng = np.random.RandomState(hw[0] * 1000 + hw[1] + batch)
    planes = torch.from_numpy(rng.randint(0, 256, (batch, 2, 2) + hw)
                              .astype(np.uint8)).to(cuda)
    ring = torch.from_numpy((rng.rand(2, 2, *hw) < 0.8).astype(np.uint8)) \
        .to(cuda)
    interior = torch.from_numpy((rng.rand(*hw) < 0.9).astype(np.uint8)) \
        .to(cuda)
    for kind in ("grad_mag_u1", "grad_hist_4_u1",
                 "grad_hist_4_u1+grad_mag_u1"):
        for smooth in (0, 1):
            mask = interior if smooth else None
            want = tfp.fpga_channels_plain(planes, ring, mask, kind, smooth)
            got = tfp.fpga_channels(planes, ring, mask, kind, smooth)
            odd = tfp.fpga_channels(_misaligned(planes), _misaligned(ring),
                                    _misaligned(interior) if smooth else None,
                                    kind, smooth)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kind, smooth)
            assert torch.equal(odd, want), (kind, smooth)


def test_fpga_slice_on_card_matches_cpu(cuda):
    path = os.path.join(ROOT, "models", "fpga_4k_synth_64.pb")
    full = wt.load(path, device="cpu")
    model = wt.model_from_stages(full.shape, full.channel_opts,
                                 full.stages[:10], full.theta[:10])
    imgs = _frames(2, (240, 320), seed=8)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        fn, _ = wt.make_batched_detector_boxes(model, (240, 320), k=512,
                                               nms_iou=0.5, device=dev)
        outs.append([a.cpu() for a in fn(imgs.to(dev))])
    assert int(outs[1][3].sum()) > 0
    for g, w_ in zip(*outs):
        assert torch.equal(g, w_)


def test_slice_on_card_matches_cpu(cuda):
    model = wt.load(FLAGSHIP)
    imgs = _frames(4, (96, 128), seed=2)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        fn, _ = wt.make_batched_detector_boxes(model, (96, 128), k=512,
                                               nms_iou=0.5, device=dev)
        outs.append([a.cpu() for a in fn(imgs.to(dev))])
    for g, w_ in zip(*outs):
        assert torch.equal(g, w_)


def test_golden_on_card(cuda):
    g = np.load(os.path.join(ROOT, "tests", "data",
                             "torch_port_vga_golden.npz"))
    fn, _ = wt.make_batched_detector_boxes(wt.load(FLAGSHIP), (480, 640),
                                           k=1024, nms_iou=0.5, device=cuda)
    rects, scores, valid, count, _ = (
        a.cpu().numpy() for a in fn(torch.from_numpy(g["frames"]).to(cuda)))
    np.testing.assert_array_equal(count, g["raw_counts"])
    split = np.cumsum(g["kept_counts"])[:-1]
    for b, (r_ref, s_ref) in enumerate(zip(np.split(g["kept_rects"], split),
                                           np.split(g["kept_scores"],
                                                    split))):
        got = np.concatenate([rects[b][valid[b]],
                              scores[b][valid[b]][:, None]], 1)
        ref = np.concatenate([r_ref, s_ref[:, None]], 1)
        np.testing.assert_array_equal(got[np.lexsort(got.T)],
                                      ref[np.lexsort(ref.T)])


def _deep_model(device, n_stages=40, seed=1, depth=5):
    """A seeded model of depth-5 trees (by default): its runtime tables are
    general (not complete heaps) and padded to 64 stages (at 40 stages)."""
    rng = np.random.RandomState(seed)
    stages = []
    for _ in range(n_stages):
        st = random_deep_stage(rng, (12, 12), 4, depth=depth)
        st["threshold"] = rng.uniform(0, 300, len(st["threshold"])) \
            .astype(np.float32)
        stages.append(st)
    theta = [-0.6 - 0.1 * t if t % 2 else -np.inf for t in range(n_stages)]
    model = wt.load(FLAGSHIP, device=device)
    return wt.model_from_stages(model.shape, model.channel_opts, stages, theta,
                                device=device)


@pytest.mark.parametrize("hw,npo", [((96, 128), 2), ((480, 640), 8)])
def test_response_kernels_match_plain_on_card(cuda, hw, npo):
    """B4 (n_stages_cap None and 12) and B6 (complete-heap, deep general
    and padded tables) bitwise against their plain versions: hs at every
    origin, alive, n_weak."""
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, npo, (12, 12),
                                         halo=1)
    canvas = channel_canvas(packed, hw, 1, tch.grad_hist,
                            cuda)(_frames(3, hw, 4).to(cuda))
    valid = window_grid(packed, (12, 12), cuda).valid
    models = [wt.load(FLAGSHIP, device=cuda), wt.load(HARD256, device=cuda),
              _deep_model(cuda)]
    for model in models[:2]:
        for cap in (None, 12):
            got = tcs.cascade_response(canvas, valid, model._operands(), cap)
            want = tcs.cascade_response_plain(canvas, valid,
                                              model._operands(), cap)
            torch.cuda.synchronize()
            for g, w_ in zip(got, want):
                assert torch.equal(g, w_)
    for model in models:
        casc, _ = model._get_cascade()
        got = tc.cascade_response_grid(canvas, casc, (12, 12), valid)
        want = tc.cascade_response_grid_plain(canvas, casc, (12, 12), valid)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
    assert not models[2]._get_cascade()[1].complete


def test_model_api_on_card_matches_cpu(cuda):
    imgs = _frames(2, (96, 128), seed=5).numpy()
    on = {dev: [wt.load(p, device=dev) for p in (FLAGSHIP, HARD256)]
          for dev in (cuda, "cpu")}
    for (gpu_m, cpu_m) in zip(on[cuda], on["cpu"]):
        for img in imgs:
            for call in (lambda m: m.detect(img),
                         lambda m: m.detect_topk(img, k=64, nms_iou=0.5)):
                a, b = call(gpu_m), call(cpu_m)
                np.testing.assert_array_equal(a.get(), b.get())
                np.testing.assert_array_equal(a.get_field("scores"),
                                              b.get_field("scores"))
            a, b = gpu_m.scan_packed(img), cpu_m.scan_packed(img)
            assert torch.equal(a[0].cpu(), b[0])
            for x, y in zip(a[2:], b[2:]):
                np.testing.assert_array_equal(x, y)
        assert gpu_m.cost_stats()["n_weak"] == cpu_m.cost_stats()["n_weak"]
    a = wt.detect(imgs[0], *on[cuda], response_scale=[1, 0.5])
    b = wt.detect(imgs[0], *on["cpu"], response_scale=[1, 0.5])
    for f in ("scores", "label"):
        np.testing.assert_array_equal(a.get_field(f), b.get_field(f))


def _walks_match_plain(canvas, valid, model, caps=(None,)):
    """B3, B4 at each n_stages_cap and B6 on the model's padded runtime
    tables, bitwise against their plain versions."""
    m, n = model.shape[:2]
    ops = model._operands()
    pairs = [(tcs.cascade_masked(canvas, valid, ops),
              tcs.cascade_masked_plain(canvas, valid, ops))]
    for cap in caps:
        pairs.append((tcs.cascade_response(canvas, valid, ops, cap),
                      tcs.cascade_response_plain(canvas, valid, ops, cap)))
    casc, _ = model._get_cascade()
    pairs.append((tc.cascade_response_grid(canvas, casc, (m, n), valid),
                  tc.cascade_response_grid_plain(canvas, casc, (m, n),
                                                 valid)))
    torch.cuda.synchronize()
    for got, want in pairs:
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
    return pairs


@pytest.mark.parametrize("hw", [(12 + 3, 12 + 50), (12 + 40, 12 + 5),
                                (12 + 1, 12 + 1), (12 + 19, 12 + 77)])
def test_walk_small_grids_on_card(cuda, hw):
    """The walk on grids smaller than (or ragged against) the 8 x 32 tile
    of origins, with holes in the valid mask: B3, B4 with n_stages_cap 0,
    1 and all, B6 on the deep model's padded tables (24 inactive
    stages)."""
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    canvas = torch.from_numpy(rng.uniform(0, 300, (3, 4) + hw)
                              .astype(np.float32)).to(cuda)
    valid = torch.from_numpy((rng.rand(hw[0] - 12, hw[1] - 12) < 0.8)
                             .astype(np.uint8)).to(cuda)
    for model in (wt.load(FLAGSHIP, device=cuda), _deep_model(cuda)):
        _walks_match_plain(canvas, valid, model, caps=(0, 1, None))


def test_walk_tables_past_shared_memory_on_card(cuda):
    """Cascades whose packed records exceed the kernel's shared-memory
    budget (256 depth-5 stages, 1024 depth-2 stages) are read from global
    memory by the same walk; 40 depth-5 stages fit."""
    hw = (96, 128)
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, 2, (12, 12),
                                         halo=1)
    canvas = channel_canvas(packed, hw, 1, tch.grad_hist,
                            cuda)(_frames(2, hw, 9).to(cuda))
    valid = window_grid(packed, (12, 12), cuda).valid
    big = _deep_model(cuda, n_stages=256, seed=2)
    small = _deep_model(cuda)
    # 1024 depth-2 stages: the HEAP2 layout, 48 KB
    big2 = _deep_model(cuda, n_stages=1024, seed=3, depth=2)
    shape = tuple(canvas.shape[1:])
    size = lambda m: m._operands().records(shape).data.numel() * 4
    assert size(big) > 48 * 1024 and size(big2) > 40 * 1024
    assert size(small) < 40 * 1024
    assert big2._operands().records(shape).layout == tc.HEAP2
    for model in (big, small, big2):
        pairs = _walks_match_plain(canvas, valid, model, caps=(1, None))
        assert int(pairs[0][0][2].sum()) > 0  # some windows survive


def _fast_planes(rng, shape, kind):
    """Random (B, 2, 2, H, W) planes of B2f's three element types: uint8,
    float32 in [0, 256), and bfloat16 roundings of such floats."""
    if kind == "uint8":
        return torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
    vals = torch.from_numpy((rng.rand(*shape) * 256).astype(np.float32))
    return vals if kind == "float32" else vals.to(torch.bfloat16)


#: B2d's and B2f's tiling edges: widths off the 128-column tile, float32
#: widths no multiple of 4 (5, 45, 131, 257), multiples of 4, 8 and 16
#: (132, 128, 256), heights off the 16- and 14-row tiles
GH_FLOAT_EDGES = [(1, 1), (3, 5), (17, 45), (33, 131), (14, 128), (70, 257),
                  (104, 128), (33, 132), (70, 256)]


@pytest.mark.parametrize("hw", GH_FLOAT_EDGES)
@pytest.mark.parametrize("kind", ["uint8", "float32", "bfloat16"])
def test_grad_hist_fast_matches_plain_on_card(cuda, hw, kind):
    """B2f bitwise (the bfloat16 bits) against its plain version, for each
    plane type, both smooths, batch 1 and 3, a mask that is set on the
    canvas border and a random one, the planes and mask also starting one
    element past an aligned start (the word copies; bfloat16 and float32
    also 2 and 4 bytes off 16: the word copies instead of TMA)."""
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    for batch in (1, 3):
        planes = _fast_planes(rng, (batch, 2, 2) + hw, kind).to(cuda)
        masks = [torch.ones(hw, dtype=torch.uint8, device=cuda),
                 torch.from_numpy((rng.rand(*hw) < 0.7).astype(np.uint8))
                 .to(cuda)]
        for smooth, mask in ((0, None), (1, masks[0]), (1, masks[1])):
            want = tcc.grad_hist_fast_plain(planes, mask, smooth)
            got = tcc.grad_hist_fast(planes, mask, smooth)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16),
                               want.view(torch.int16)), (batch, smooth)
            for elems in (1, 3):
                odd = tcc.grad_hist_fast(
                    _misaligned(planes, elems),
                    None if mask is None else _misaligned(mask, elems),
                    smooth)
                assert torch.equal(odd.view(torch.int16),
                                   want.view(torch.int16)), (batch, smooth,
                                                             elems)


def test_cascade_fast_matches_plain_on_card(cuda):
    """B3f over a bfloat16 canvas against its plain version and against B3
    over the canvas's float32 copy (the three committed models; and
    chip_smoke.py's B3f edges: grids under one tile, rows off 16 bytes, a
    canvas one element off a word, windows 8, 12 and 24, C = 1, 4 and 5,
    batch 1 and 3, deep-tree, oversized, one-stage and never-rejecting
    cascades), each launch counted under the path its front read the
    canvas by; B4 over the canvas, with n_stages_cap."""
    rng = np.random.RandomState(4)
    hw = (96, 128)
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, 2, (12, 12),
                                         halo=1)
    planes = _fast_planes(rng, (3, 2, 2, packed.canvas_h, packed.canvas_w),
                          "float32").to(cuda)
    mask = torch.as_tensor(packed.smooth_interior_mask().astype(np.uint8),
                           device=cuda)
    canvas = tcc.grad_hist_fast(planes, mask, 1)
    valid = torch.as_tensor(packed.valid_mask((12, 12)).astype(np.uint8),
                            device=cuda)

    def fast(cv, evalid, eops):
        """B3f's outputs and the front paths its launch was counted by."""
        before = {p: launches["cascade_fast/" + p] for p in tcs.FAST_PATHS}
        out = tcs.cascade_masked(cv, evalid, eops)
        return out, [p for p in tcs.FAST_PATHS
                     if launches["cascade_fast/" + p] != before[p]]

    for path in (FLAGSHIP, HARD64, HARD256):
        ops = wt.load(path, device=cuda)._operands(cuda)
        got, moved = fast(canvas, valid, ops)
        assert moved == ["tma"]
        for want in (tcs.cascade_masked_plain(canvas, valid, ops),
                     tcs.cascade_masked(canvas.float(), valid, ops)):
            for g, w_ in zip(got, want):
                assert torch.equal(g, w_)
        if path == HARD64:
            continue
        for cap in (None, 12):
            got = tcs.cascade_response(canvas, valid, ops, cap)
            for want in (tcs.cascade_response_plain(canvas, valid, ops, cap),
                         tcs.cascade_response(canvas.float(), valid, ops,
                                              cap)):
                for g, w_ in zip(got, want):
                    assert torch.equal(g, w_)
    paths = set()
    for label, cv, evalid, eops in b3f_edges(tcs, cuda):
        got, moved = fast(cv, evalid, eops)
        assert len(moved) == 1, label
        paths.update(moved)
        for want in (tcs.cascade_masked_plain(cv, evalid, eops),
                     tcs.cascade_masked(cv.float(), evalid, eops)):
            for g, w_ in zip(got, want):
                assert torch.equal(g, w_), label
    assert paths == {"tma", "global", "none"}


@pytest.mark.parametrize("frames,fast_float", [("uint8", "f32"),
                                               ("float32", "f32"),
                                               ("float32", "bf16")])
def test_fast_slice_on_card_matches_cpu(cuda, frames, fast_float):
    model = wt.load(FLAGSHIP)
    imgs = _frames(4, (96, 128), seed=2)
    if frames == "float32":
        imgs = imgs.float() + torch.from_numpy(
            np.random.RandomState(3).rand(4, 96, 128).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        fn, _ = wt.make_batched_detector_boxes(
            model, (96, 128), k=512, nms_iou=0.5, device=dev, fast=True,
            fast_float=fast_float)
        outs.append([a.cpu() for a in fn(imgs.to(dev))])
    for g, w_ in zip(*outs):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("hw", GH_FLOAT_EDGES)
def test_grad_hist_float_matches_plain_on_card(cuda, hw):
    """B2d bitwise against its plain version (both native f64), both
    smooths, batch 1 and 3, a mask set on the canvas border and a random
    one, the planes and mask also starting one and three elements past an
    aligned start (4 and 12 bytes off 16)."""
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    for batch in (1, 3):
        planes = _fast_planes(rng, (batch, 2, 2) + hw, "float32").to(cuda)
        masks = [torch.ones(hw, dtype=torch.uint8, device=cuda),
                 torch.from_numpy((rng.rand(*hw) < 0.7).astype(np.uint8))
                 .to(cuda)]
        for smooth, mask in ((0, None), (1, masks[0]), (1, masks[1])):
            want = tcc.grad_hist_float_plain(planes, mask, smooth)
            got = tcc.grad_hist_float(planes, mask, smooth)
            assert torch.equal(got, want), (batch, smooth)
            for elems in (1, 3):
                odd = tcc.grad_hist_float(
                    _misaligned(planes, elems),
                    None if mask is None else _misaligned(mask, elems),
                    smooth)
                assert torch.equal(odd, want), (batch, smooth, elems)


@pytest.mark.parametrize("fast", [False, True])
def test_float_and_bucketed_on_card_match_cpu(cuda, fast):
    """Float frames through make_batched_detector_boxes, and
    BucketedDetector over three sizes of one bucket (uint8 and float
    frames), on the card equal their CPU runs."""
    from waldboost_tpu_torch.parallel.detect import BucketedDetector
    model = wt.load(FLAGSHIP)
    rng = np.random.RandomState(5)
    imgs = (_frames(4, (96, 128), seed=2).float()
            + torch.from_numpy(rng.rand(4, 96, 128).astype(np.float32)))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        fn, _ = wt.make_batched_detector_boxes(model, (96, 128), k=512,
                                               nms_iou=0.5, device=dev,
                                               fast=fast)
        outs.append([a.cpu() for a in fn(imgs.to(dev))])
    for g, w_ in zip(*outs):
        assert torch.equal(g, w_)
    frames = [_frames(1, hw, seed=i)[0].numpy()
              for i, hw in enumerate(((90, 120), (101, 127), (65, 70)))]
    frames += [f.astype(np.float32) + 0.5 for f in frames]
    got = [BucketedDetector(model, bucket=64, k=512, nms_iou=0.5, fast=fast,
                            device=dev).detect_many(frames)
           for dev in (cuda, torch.device("cpu"))]
    for a, b in zip(*got):
        np.testing.assert_array_equal(a.get(), b.get())
        np.testing.assert_array_equal(a.get_field("scores"),
                                      b.get_field("scores"))


def test_grad_hist_second_card(cuda):
    """The dynamic shared memory above 48 KB (B2 and B2f with the smooth,
    B2f's float planes) is opted into per device: canvases on cuda:1
    after cuda:0 equal their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    rng = np.random.RandomState(6)
    hw = (70, 257)
    planes = torch.from_numpy(rng.randint(0, 256, (2, 2, 2) + hw)
                              .astype(np.uint8))
    mask = torch.from_numpy((rng.rand(*hw) < 0.9).astype(np.uint8))
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        p, m = planes.to(dev), mask.to(dev)
        got = tcc.grad_hist(p, m, 1)
        assert torch.equal(got, tcc.grad_hist_plain(p, m, 1)), dev
        for q in (p, p.float(), p.to(torch.bfloat16)):
            got = tcc.grad_hist_fast(q, m, 1)
            want = tcc.grad_hist_fast_plain(q, m, 1)
            assert torch.equal(got.view(torch.int16),
                               want.view(torch.int16)), (dev, q.dtype)
        torch.cuda.synchronize(dev)


@pytest.fixture(scope="module")
def golden_pools():
    """The pools of stages 0, 2 and 5 of BASELINE config 4, teacher-forced
    against the training golden on the card (chip_smoke.py phase 6t)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    dev = torch.device("cuda", torch.cuda.current_device())
    _, pools = train_golden_run(wt, dev, np.load(TRAIN_GOLDEN),
                                refit=(0, 2, 5))
    return dev, pools


def _fit(pool, device):
    X0, W0, X1, W1 = pool
    return wt.DTree.fit(X0, W0, X1, W1, max_depth=TRAIN_DEPTH, device=device)


@pytest.mark.parametrize("stage", [0, 2, 5])
def test_fit_on_card_matches_cpu(golden_pools, stage):
    """The card's fit equals the port's CPU fit (structure and thresholds
    bitwise, predictions within 1e-5) and repeats bitwise."""
    dev, pools = golden_pools
    card = _fit(pools[stage], dev)
    cpu = _fit(pools[stage], "cpu")
    assert tree_diff(card, cpu.to_stage_dict()) is None
    again = _fit(pools[stage], dev).to_stage_dict()
    for k, v in card.to_stage_dict().items():
        assert np.array_equal(v, again[k]), k


def test_fit_ignores_global_tf32(golden_pools, monkeypatch):
    """With TF32 switched on globally the fit's products still run in full
    float32 (the precision seen inside is "highest"), the tree is bitwise
    the one fitted with TF32 off, and the caller's setting is restored."""
    from waldboost_tpu_torch.ops import fit as tfit
    dev, pools = golden_pools
    seen = []
    inner = tfit._cum_masses

    def spy(*args):
        seen.append(torch.get_float32_matmul_precision())
        return inner(*args)

    monkeypatch.setattr(tfit, "_cum_masses", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = _fit(pools[0], dev).to_stage_dict()
        torch.backends.cuda.matmul.allow_tf32 = True
        on = _fit(pools[0], dev).to_stage_dict()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen and set(seen) == {"highest"}
    for k, v in off.items():
        assert np.array_equal(v, on[k]), k


def test_fpga_train_golden_on_card(cuda):
    """wt.fpga.train on the card, teacher-forced against the JAX golden
    (chip_smoke.py phase 6v): pools, counters, trees, thetas and learner
    stats of both stages."""
    model, _ = fpga_train_golden_run(wt, cuda, np.load(FPGA_TRAIN_GOLDEN))
    assert len(model) == 2 and model.device.type == "cuda"


def test_device_train_golden_on_card(cuda):
    """The device-pool trainer (config 4b) on the card, teacher-forced
    against the JAX golden (chip_smoke.py phase 6w): pools, counters,
    trees, thetas, p0/p1, counts and pruned pools of all 6 stages; then the
    FPGA options in-step against their own golden."""
    model, _ = device_train_golden_run(wt, cuda,
                                       np.load(DEVICE_TRAIN_GOLDEN))
    assert len(model) == 6 and model.device.type == "cuda"
    model, _ = device_train_golden_run(
        wt, cuda, np.load(DEVICE_FPGA_TRAIN_GOLDEN), fpga=True)
    assert len(model) == 2 and model.device.type == "cuda"


@pytest.mark.parametrize("channels,smooth", [("grad_hist", 1),
                                             ("grad_hist_4_u1", 0)])
def test_channel_pyramid_on_card_matches_cpu(cuda, channels, smooth):
    """channel_pyramid on the card (B1 and B2 or B5) equals its plain run
    on the CPU bitwise, every level of a VGA frame."""
    img = _frames(1, (480, 640), seed=6)[0].numpy()
    opts = dict(shrink=2, n_per_oct=8, smooth=smooth, channels=channels)
    got = list(tch.channel_pyramid(img, opts, device=cuda))
    want = list(tch.channel_pyramid(img, opts, device="cpu"))
    assert len(got) == len(want) > 30
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == sb and np.array_equal(a, b)


def test_canvas_golden_on_card(cuda):
    """The image-space cascades on the card against the JAX golden
    (chip_smoke.py's shrink-1 and grad_mag phases) on all five VGA
    frames: the shrink-1 cascade bitwise through Model.detect, the
    batched and the bucketed detector, the grad_mag ones within the flip
    bound."""
    g = np.load(CANVAS_GOLDEN)
    frames = canvas_golden_frames(g)
    res = canvas_golden_run(wt, cuda, g, frames, list(range(len(frames))))
    assert res["s1"][0] > 0 and res["grad_mag"][0] > 0


@pytest.mark.parametrize("floats", [False, True], ids=["uint8", "float"])
@pytest.mark.parametrize("key", ["s1", "grad_mag", "hist_mag"])
def test_image_canvas_on_card_matches_cpu(cuda, key, floats):
    """The image-space canvas (plain torch, unfused) on the card equals
    its CPU run bitwise on a VGA frame."""
    model = wt.load(canvas_model_path(key), device=cuda)
    packed, smooth, cf = model._plan((480, 640))
    img = _frames(1, (480, 640), seed=8)
    if floats:
        img = img.float() + 0.25
    got = channel_canvas(packed, (480, 640), smooth, cf, cuda)(img.to(cuda))
    want = channel_canvas(packed, (480, 640), smooth, cf,
                          torch.device("cpu"))(img)
    assert torch.equal(got.cpu(), want)


def test_verifier_ignores_global_tf32(cuda):
    """With TF32 switched on globally (matmul and cuDNN) the verifier's
    products and convolutions still run in full float32 (the precision
    seen inside each call), its scores hold the JAX golden's tolerance,
    and the caller's settings come back."""
    g = np.load(CANVAS_GOLDEN)
    scenes = canvas_golden_frames(g)[:int(g["n_scenes"])]
    verifier = golden_verifier(wt, g)
    seen, probe = tf32_probe(wt, verifier, cuda)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        res, _ = verifier_golden_run(wt, cuda, g, scenes, [0, 1, 2],
                                     verifier)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        probe.remove()
    assert seen and all(p == "highest" and c in ("ieee", True)
                        for p, c in seen)
    assert sum(n for n, _ in res) > 300


def test_verifier_train_on_card(cuda):
    """Verifier training (chip_smoke.py phase 7a at a small size: 200
    windows a class, 2 epochs of 10 batches of 64, dropout off) with TF32
    switched on globally: two runs on the card bitwise equal, every pass
    in full float32, the parameters within VTRAIN_PARAM_TOL of the CPU's
    run; with dropout on, two card runs are bitwise equal too (masks
    from the seeded generator)."""
    from waldboost_tpu_torch import verification as TV
    X0, H0, X1, H1 = verifier_pools(n=200)
    _, init = TV.init_verifier((12, 12, 4), seed=1)
    kw = dict(epochs=2, steps=10, batch_size=64, lr=1e-4, seed=0,
              verbose=False)
    module = dropout_off(wt)
    seen, probe = precision_probe(module)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        a, b = (TV.train(module, init, X0, H0, X1, H1, device=cuda, **kw)
                for _ in range(2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        probe.remove()
    assert full_f32(seen)
    assert all(torch.equal(a[k], b[k]) for k in a)
    ref = TV.train(module, init, X0, H0, X1, H1, device="cpu", **kw)
    assert max(float((a[k] - ref[k]).abs().max()) for k in ref) \
        <= VTRAIN_PARAM_TOL
    drop = TV.VerifierCNN((12, 12, 4))
    c, d = (TV.train(drop, init, X0, H0, X1, H1, device=cuda, **kw)
            for _ in range(2))
    assert all(torch.equal(c[k], d[k]) for k in c)
    assert not all(torch.equal(c[k], a[k]) for k in c)


def test_mesh_on_card(cuda):
    """A mesh of the current card repeated four times, and of the real
    cards when two or more are visible: sharded VGA serving (8 frames a
    shard) and a tile-sharded frame bitwise the unsharded paths, and
    config 4b's device-pool trainer over the mesh bitwise its golden
    (chip_smoke.py's phases 8a, 8c and 8e at a smaller size)."""
    from waldboost_tpu_torch.parallel.detect import \
        make_tile_sharded_detector
    from waldboost_tpu_torch.parallel.mesh import (gather, make_mesh,
                                                   shard_array)

    dev = torch.device("cuda", torch.cuda.current_device())
    meshes = [make_mesh(devices=[dev] * 4)]
    if torch.cuda.device_count() >= 2:
        meshes.append(make_mesh(n_devices=min(4, torch.cuda.device_count())))
    model = wt.load(FLAGSHIP, device=dev)
    hw = (480, 640)
    frames = _frames(8, hw, seed=3)
    fu, _ = wt.make_batched_detector_boxes(model, hw, k=256, nms_iou=0.5,
                                           device=dev)
    want = fu(frames.to(dev))
    fr, _ = wt.make_batched_detector(model, hw, device=dev)
    hu, au, nu = fr(frames[:1].to(dev))
    for mesh in meshes:
        fs, _ = wt.make_batched_detector_boxes(model, hw, k=256, nms_iou=0.5,
                                               mesh=mesh)
        outs = fs(shard_array(torch.cat([frames] * mesh.size), mesh))
        for o, w in zip(outs, want):
            assert [s.device for s in o] == list(mesh.local_devices)
            g = gather(o, mesh, dev)
            for s in range(mesh.size):
                assert torch.equal(g[8 * s:8 * (s + 1)], w)
        ft, _ = make_tile_sharded_detector(model, hw, mesh)
        hs, alive, nw = ft(frames[0])
        assert torch.equal(hs, hu[0]) and torch.equal(alive, au[0])
        assert int(nw) == int(nu[0])
        trained, _ = device_train_golden_run(
            wt, dev, np.load(DEVICE_TRAIN_GOLDEN), mesh=mesh)
        assert len(trained) == 6


@pytest.mark.parametrize("overflow", [False, True])
def test_compact_and_suffix_match_plain_on_card(cuda, overflow):
    """Kernels S2 (topk_masked over B4's hs and alive) and S1
    (cascade_suffix_sparse) on the card, bitwise their plain versions on
    the same CUDA tensors, on the inputs the flagship's two-phase detector
    gives them (VGA scenes), with a capacity the prefix survivors fit and
    one they overflow; S1 over the float32 and the bfloat16 canvas of
    fast mode."""
    from chip_smoke import TpInputs, scene_batch
    model = wt.load(FLAGSHIP)
    scene = scene_batch(4).to(cuda)
    kw = dict(prefix=2, capacity=512) if overflow else {}
    for fast in (False, True):
        det, _ = wt.make_batched_detector_boxes(model, (480, 640),
                                                device=cuda, two_phase=True,
                                                fast=fast, **kw)
        inp = TpInputs(det, scene)
        if overflow:
            assert bool((inp.count > det.cap).any())
        for kernel, (call, plain) in inp.calls().items():
            for got, want in zip(call(), plain()):
                assert got.device == want.device == inp.cv.device
                assert torch.equal(got, want), kernel


def test_twophase_golden_on_card(cuda):
    """Two-phase (JAX's defaults and an overflowing setting) and row-wise
    serving on the flagship's VGA batch: every output bitwise the JAX
    golden (tests/data/torch_port_twophase_golden.npz)."""
    from chip_smoke import TWOPHASE_GOLDEN, twophase_golden_run
    diffs, _ = twophase_golden_run(wt, cuda, np.load(TWOPHASE_GOLDEN),
                                   wt.load(FLAGSHIP))
    assert not any(diffs.values()), diffs


def test_per_level_canvas_on_card(cuda, tmp_path):
    """A user channel function's per-level canvas and compute_pyramid on
    the card equal the CPU's bitwise (plain torch, no fused operation),
    uint8 and float32 frames; the JAX-trained user_grad model serves its
    golden (tests/data/torch_port_custom_channels_golden.npz) bitwise."""
    from chip_smoke import CUSTOM_GOLDEN, custom_golden_run, user_grad
    tch.register_channel_function(tch.ChannelFunction("user_grad",
                                                      user_grad, 2))
    cf = tch.resolve_channel_function("user_grad")
    hw = (97, 131)
    packed = packing._packed_plan_cached(*hw, 2, 3, (8, 8), halo=cf.halo)
    imgs = _frames(2, hw, seed=31).numpy()
    for x in (imgs, imgs.astype(np.float32) + 0.25):
        got = channel_canvas(packed, hw, 1, cf, cuda)(
            torch.from_numpy(x).to(cuda)).cpu()
        want = channel_canvas(packed, hw, 1, cf, torch.device("cpu"))(
            torch.from_numpy(x))
        assert torch.equal(got, want)
        opts = dict(shrink=2, n_per_oct=3, smooth=1, channels="user_grad")
        for (a, sa), (b, sb) in zip(tch.compute_pyramid(x[0], opts, cuda),
                                    tch.compute_pyramid(x[0], opts, "cpu")):
            assert sa == sb and torch.equal(a.cpu(), b)
    diffs, _ = custom_golden_run(wt, cuda, np.load(CUSTOM_GOLDEN),
                                 str(tmp_path))
    assert not any(diffs.values()), diffs


def _grid_size(model, hw):
    det, _ = wt.make_batched_detector_boxes(model, hw, device="cpu")
    gu, gv = det.grid.valid.shape
    return gu * gv


@pytest.mark.parametrize("kind", ["ties", "all_inf", "all_finite",
                                  "around_k", "far_above",
                                  "signed_zeros_nonfinite"])
@pytest.mark.parametrize("size", ["vga", "4k"])
def test_topk_matches_plain_on_card(cuda, size, kind):
    """Kernel S2 (ops/nms.py::topk_masked) bitwise its plain version on
    the card in both input forms, batch 8, on chip_smoke.topk_maps at the
    flagship's VGA grid and config 5's 4K grid: k = 1, the paths' k, 8192
    and the whole map."""
    from chip_smoke import HW4K, topk_check, topk_maps
    model, hw, ks = ((wt.load(FLAGSHIP, device="cpu"), (480, 640),
                      (1, 1024, 8192)) if size == "vga" else
                     (wt.load(os.path.join(ROOT, "models",
                                           "fpga_4k_synth_64.pb"),
                              device="cpu"), HW4K, (1, 128, 8192)))
    n = _grid_size(model, hw)
    for k in ks + (n,):
        hs, alive = topk_maps(kind, 8, n, k, 17)
        bad, _ = topk_check(torch.from_numpy(hs).to(cuda),
                            torch.from_numpy(alive).to(cuda), k)
        assert bad == 0, (size, kind, k)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("kind", ["ties", "all_inf", "all_finite",
                                  "around_k", "far_above",
                                  "signed_zeros_nonfinite"])
def test_extract_matches_plain_on_card(cuda, kind, batch):
    """The dense extraction on the card (ops/nms.py::extract_detections:
    S2 with its box epilogue, one launch counted under compact/boxes)
    bitwise the plain chain on the CPU (topk_masked_plain, the count's
    clamp, origin_boxes): rects, scores, valid, count and the origins, on
    chip_smoke.topk_maps over the flagship's VGA grid and level tables, k
    = 1, 1024, 4096 (sorted in several runs) and the whole grid; the
    counts given are the maps' survivors and off by 1, -1 and 5000; some
    taken origins lie outside every level (level_id -1)."""
    from chip_smoke import topk_maps
    from waldboost_tpu_torch.ops.nms import extract_detections
    det, _ = wt.make_batched_detector_boxes(wt.load(FLAGSHIP, device="cpu"),
                                            (480, 640), device="cpu")
    g = det.grid
    gu, gv = g.level_id.shape
    tables = (g.level_id, g.offsets, g.inv_scales)
    off = np.array([0, 1, -1, 5000] * 2, np.int32)[:batch]
    outside = 0
    for k in (1, 1024, 4096, gu * gv):
        hs, alive = topk_maps(kind, batch, gu * gv, k, 23)
        masked = np.where(alive, hs, -np.inf).astype(np.float32)
        count = torch.from_numpy(np.isfinite(masked).sum(1).astype(np.int32)
                                 + off)
        masked = torch.from_numpy(masked).reshape(batch, gu, gv)
        want = extract_detections(masked, count, *tables, g.window, k,
                                  with_coords=True)
        before = launches["compact/boxes"]
        got = extract_detections(masked.to(cuda), count.to(cuda),
                                 *(t.to(cuda) for t in tables), g.window, k,
                                 with_coords=True)
        assert launches["compact/boxes"] == before + 1
        for name, a, b in zip(("rects", "scores", "valid", "count", "rs",
                               "cs"), got, want):
            a = a.cpu()
            assert a.dtype == b.dtype and a.shape == b.shape, (name, k)
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (name, k)
        outside += int((g.level_id[want[4], want[5]] == -1)[want[2]].sum())
    if kind != "all_inf" and not (kind == "ties" and batch == 1):
        assert outside > 0


@pytest.mark.parametrize("kind", ["far_above", "ties"])
def test_topk_multi_block_sort_on_card(cuda, kind):
    """S2 with k = 65536 on a 4K map, so that runs of TOPK_RUN keys are
    sorted by several blocks and merged: bitwise its plain version."""
    from chip_smoke import HW4K, TOPK_BIG_K, topk_check, topk_maps
    from waldboost_tpu_torch.ops.nms import TOPK_RUN
    n = _grid_size(wt.load(os.path.join(ROOT, "models",
                                        "fpga_4k_synth_64.pb"),
                           device="cpu"), HW4K)
    hs, alive = topk_maps(kind, 8, n, TOPK_BIG_K, 29)
    assert TOPK_BIG_K > TOPK_RUN
    bad, _ = topk_check(torch.from_numpy(hs).to(cuda),
                        torch.from_numpy(alive).to(cuda), TOPK_BIG_K)
    assert bad == 0


def test_extraction_launches_topk_without_sync_on_card(cuda):
    """The dense extraction and two-phase's finish (JAX's defaults and the
    overflowing setting) at VGA and 4K run S2, never torch.sort on the
    card, and never synchronize with the host (nms_iou=None, PyTorch's
    sync debug mode "error"); the dense path launches S2 once a batch."""
    from chip_smoke import HW4K, TP_OVER, no_sync_run, scene_batch
    synth = wt.load(FLAGSHIP)
    fpga = wt.load(os.path.join(ROOT, "models", "fpga_4k_synth_64.pb"))
    scene = scene_batch(8).to(cuda)
    noise4k = _frames(8, HW4K, 3).to(cuda)
    make = lambda m, hw, **kw: wt.make_batched_detector_boxes(
        m, hw, device=cuda, **kw)[0]
    runs = [(make(synth, (480, 640), k=1024), scene),
            (make(fpga, HW4K, k=128), noise4k),
            (make(synth, (480, 640), two_phase=True), scene),
            (make(synth, (480, 640), two_phase=True, **TP_OVER), scene),
            (make(fpga, HW4K, k=128, two_phase=True), noise4k),
            (make(fpga, HW4K, k=128, two_phase=True, **TP_OVER), noise4k)]
    for i, (det, images) in enumerate(runs):
        before = launches["compact"]
        assert no_sync_run(det, images) == [], i
        torch.cuda.synchronize()
        # two calls of finish (the warm one and the checked one)
        assert launches["compact"] - before == (2 if i < 2 else 4), i
