"""PyTorch port, the CNN verifier's training half on the CPU
(``waldboost_tpu_torch/verification.py``: ``exploss``, ``init_verifier``,
``train``), held against the JAX package's flax/optax functions
(``waldboost_tpu/verification.py``) and on ``tests/test_verification.py``'s
contracts.

Tolerances:

* ``exploss``: within 1e-6 relative of JAX's (XLA's and torch's float32
  ``exp`` may round apart by an ULP); the clamp values exactly.
* ``init_verifier``: flax's distributions, not its values: shapes, zero
  biases, GroupNorm scales one, every kernel weight within 2 sigma of 0
  (sigma = sqrt(1 / fan_in) / 0.8796, the truncated normal's scale), and
  each kernel's sample standard deviation within 4 / sqrt(2 n) (relative,
  n its weights) of sqrt(1 / fan_in), which flax's own draw also meets.
* ``train`` teacher-forced (dropout off on both sides: JAX's ``train`` is
  handed a wrapper whose ``apply`` forces ``deterministic=True``): the
  printed epoch losses equal, every parameter within 1e-5 absolute of
  JAX's (measured: 1.3e-6 after 2 x 50 steps at 12 x 12 x 4; the
  convolutions, GroupNorm's statistics, the loss's mean and Adam's
  arithmetic round apart, XLA may fuse multiply-adds).
"""

import contextlib
import io
import os
import sys
from itertools import islice

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax.numpy as jnp

from waldboost_tpu import verification as V

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import verification as TV
from waldboost_tpu_torch.convert import verifier_state_dict

from test_verification import _toy_pools

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (CLI_GOLDEN, dropout_off,  # noqa: E402
                        printed_losses, verifier_pools, vtrain_golden_run)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_torch_cli_golden import Deterministic  # noqa: E402

torch.set_num_threads(2)

PARAM_TOL = 1e-5


def test_exploss_matches_jax():
    rng = np.random.RandomState(0)
    y = np.where(rng.rand(257) < 0.5, -1.0, 1.0).astype(np.float32)
    yp = (rng.randn(257) * 6).astype(np.float32)
    yp[:4] = [100.0, -100.0, 15.0, -15.0]
    want = np.asarray(V.exploss(jnp.asarray(y), jnp.asarray(yp)))
    got = TV.exploss(torch.from_numpy(y), torch.from_numpy(yp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    clamped = (want == np.float32(1e-6)) | (want == np.float32(1e3))
    assert clamped.sum() >= 4
    np.testing.assert_array_equal(got[clamped], want[clamped])


def test_exploss_clamped():
    """tests/test_verification.py::test_exploss_clamped on the port."""
    out = TV.exploss(torch.tensor([1.0, -1.0, 1.0]),
                     torch.tensor([100.0, 100.0, -100.0])).numpy()
    np.testing.assert_allclose(out, [1e-6, 1e3, 1e3])


@pytest.mark.parametrize("shape", [(12, 12, 4), (8, 8, 4), (9, 7, 1)])
def test_init_verifier_matches_flax_distributions(shape):
    module, params = TV.init_verifier(shape, seed=3)
    assert isinstance(module, TV.VerifierCNN)
    _, fparams = V.init_verifier(shape, seed=3)
    flax = {k: v.numpy() for k, v in verifier_state_dict(fparams).items()}
    assert sorted(params) == sorted(flax)
    for name, t in params.items():
        w = t.numpy()
        assert t.dtype == torch.float32 and w.shape == flax[name].shape
        if name.endswith("bias"):
            assert not w.any()
        elif name.startswith("norms."):
            assert (w == 1).all()
        else:
            fan_in = int(np.prod(w.shape[1:]))
            std = np.sqrt(1.0 / fan_in)
            assert np.abs(w).max() <= 2 * std / 0.87962566103423978
            band = 4 / np.sqrt(2 * w.size)
            for draw in (w, flax[name]):
                assert abs(draw.std() / std - 1) <= band, (name, draw.std())
    # the state dict loads, the seed decides the draw
    module.load_state_dict(params)
    again = TV.init_verifier(shape, seed=3)[1]
    other = TV.init_verifier(shape, seed=4)[1]
    assert all(torch.equal(params[k], again[k]) for k in params)
    assert not torch.equal(params["dense0.weight"], other["dense0.weight"])


@pytest.mark.parametrize("shape,steps", [((12, 12, 4), 20), ((8, 8, 4), 15)])
def test_train_matches_jax_teacher_forced(shape, steps, capsys):
    """Dropout off on both sides, the same flax init and numpy draws:
    the printed epoch losses equal and the parameters within
    PARAM_TOL."""
    X0, H0, X1, H1 = verifier_pools(n=300, shape=shape, seed=5)
    module, params = V.init_verifier(shape, seed=2)
    kw = dict(epochs=2, steps=steps, batch_size=64, lr=1e-4, seed=7)
    want = V.train(Deterministic(module), params, X0, H0, X1, H1, **kw)
    jax_log = capsys.readouterr().out
    got = TV.train(dropout_off(wt, shape),
                   verifier_state_dict(params), X0, H0, X1, H1,
                   device="cpu", **kw)
    port_log = capsys.readouterr().out
    assert port_log == jax_log
    assert len(printed_losses(port_log)) == 2
    ref = verifier_state_dict(want)
    assert sorted(got) == sorted(ref)
    init = verifier_state_dict(params)
    for k in ref:
        assert float((got[k] - ref[k]).abs().max()) <= PARAM_TOL, k
        assert not torch.equal(got[k], init[k]), k  # every leaf trained


def test_train_leaves_module_and_params_alone():
    X0, H0, X1, H1 = verifier_pools(n=100, shape=(8, 8, 4))
    module, params = TV.init_verifier((8, 8, 4), seed=0)
    before = {k: v.clone() for k, v in params.items()}
    weight = module.dense1.weight.detach().clone()
    out = TV.train(module, params, X0, H0, X1, H1, epochs=1, steps=3,
                   verbose=False, device="cpu")
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert torch.equal(module.dense1.weight, weight)
    assert not torch.equal(out["dense1.weight"], before["dense1.weight"])


def test_train_dropout_is_seeded():
    """Dropout on: two runs with one seed are equal, another seed or
    dropout off trains other parameters."""
    X0, H0, X1, H1 = verifier_pools(n=100, shape=(8, 8, 4))
    module, params = TV.init_verifier((8, 8, 4), seed=0)
    run = lambda m, seed: TV.train(m, params, X0, H0, X1, H1, epochs=1,
                                   steps=5, verbose=False, seed=seed,
                                   device="cpu")["dense0.weight"]
    a, b, c = run(module, 0), run(module, 0), run(module, 1)
    off = run(dropout_off(wt, (8, 8, 4)), 0)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, off)


def test_dropout_masks_like_flax():
    """The port's dropout keeps an element with probability 0.8 and
    divides it by 0.8, as flax's ``Dropout``; without a generator the
    net is deterministic."""
    net = TV.VerifierCNN((8, 8, 4))
    x = torch.ones(20000)
    gen = torch.Generator().manual_seed(0)
    y = net._drop(x, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert torch.equal(net._drop(x, None), x)


def test_train_reduces_loss_and_separates():
    """tests/test_verification.py::test_train_reduces_loss_and_separates
    on the port (dropout on)."""
    rng = np.random.RandomState(0)
    X0, H0, X1, H1 = _toy_pools(rng)
    module, params = TV.init_verifier((8, 8, 4), seed=0)
    score = lambda p, X, H: TV.verify_scores(module, p, X, H, device="cpu")
    gap_before = np.mean(score(params, X1, H1)) - np.mean(
        score(params, X0, H0))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        params = TV.train(module, params, X0, H0, X1, H1, epochs=2,
                          steps=40, batch_size=32, lr=3e-4, device="cpu")
    losses = printed_losses(out.getvalue())
    assert len(losses) == 2 and losses[1] < losses[0]
    gap = np.mean(score(params, X1, H1)) - np.mean(score(params, X0, H0))
    assert gap > gap_before and gap > 0.5, (gap_before, gap)


def test_verifier_does_not_degrade_auc():
    """tests/test_verification.py::test_verifier_does_not_degrade_auc on
    the port: the verified detections rank at least as well as the raw
    cascade, within 0.03 AUC."""
    from waldboost_tpu_torch.testing import Evaluator, evaluate_model
    from waldboost_tpu_torch.utils import fake_data_generator

    gen = fake_data_generator(seed=11)
    model = wt.Model((12, 12, 4), dict(shrink=2, n_per_oct=4, smooth=1,
                                       channels="grad_hist"), device="cpu")
    pool = wt.SamplePool(min_tp=300, min_fp=300, seed=0)
    wt.train(model, gen, pool=pool, length=8,
             learner=wt.Learner(alpha=0.2, max_depth=2))
    X0, H0 = pool.get_false_positives()
    X1, H1 = pool.get_true_positives()
    module, params = TV.init_verifier(model.shape, seed=0)
    params = TV.train(module, params, X0, H0, X1, H1, epochs=2, steps=120,
                      batch_size=64, verbose=False, device="cpu")
    corpus = list(islice(fake_data_generator(seed=999), 40))
    auc_base = evaluate_model(corpus, model).evaluate()["auc"]
    ev = Evaluator()
    for i, d in enumerate(corpus, 1):
        dt = TV.detect_and_verify(d["image"], model, module, params)
        ev.add_ground_truth(i, d["groundtruth_boxes"], d["image"].shape)
        ev.add_detections(i, dt)
    auc_ver = ev.evaluate()["auc"]
    assert auc_ver >= auc_base - 0.03, (auc_base, auc_ver)


def test_verifier_train_golden_on_cpu():
    """chip_smoke.py phase 7a on the CPU: the golden's JAX run (2 x 50
    batches of 64 on 1000 windows a class) within its tolerances."""
    g = np.load(CLI_GOLDEN)
    state, err, loss_err, _, seen = vtrain_golden_run(wt, torch.device("cpu"),
                                                      g)
    assert err <= PARAM_TOL and loss_err == 0.0
    assert len(seen) == 100 and all(p == "highest" for p, _ in seen)
    assert sorted(state) == sorted(TV.init_verifier((12, 12, 4))[1])
