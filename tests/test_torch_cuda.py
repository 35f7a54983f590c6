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

sys.path.insert(0, ROOT)
from chip_smoke import random_deep_stage  # noqa: E402  (numpy only)

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
    octs = tpl.octave_buffer(tch.octave_chain(imgs, len(tables.oct_hw)))
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
    # outside the canvas, which both versions take as 0
    rng = np.random.RandomState(3)
    planes = torch.from_numpy(rng.randint(0, 256, (2, 2, 2) + hw)
                              .astype(np.uint8)).to(cuda)
    mask = torch.ones(hw, dtype=torch.uint8, device=cuda)
    got = tcc.grad_hist(planes, mask, 1)
    want = tcc.grad_hist_plain(planes, mask, 1)
    assert torch.equal(got, want)


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


def _deep_model(device, n_stages=40):
    """A seeded model of depth-5 trees: its runtime tables are general
    (not complete heaps) and padded to 64 stages."""
    rng = np.random.RandomState(1)
    stages = []
    for _ in range(n_stages):
        st = random_deep_stage(rng, (12, 12), 4, depth=5)
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
