"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded random cascades handed to both packages, seeded frames,
and the port's planes and canvas of a frame batch (plain versions on the
CPU), which the tests hand to the JAX functions as their inputs."""

import os
import sys

import numpy as np
import torch

import waldboost_tpu as wb
from waldboost_tpu.training import DTree

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import polyphase
from waldboost_tpu_torch.ops import channels as tcc
from waldboost_tpu_torch.ops import planes as tpl

from test_cascade import random_stage

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import random_deep_stage  # noqa: E402  (numpy only)


def make_model_pair(n_stages=8, shape=(8, 8, 4), seed=0, n_per_oct=2,
                    smooth=1, thr_max=300.0, depth=None, open_stages=0,
                    channels="grad_hist"):
    """A JAX model over ``channels`` with ``n_stages`` random depth-2 trees
    (or trees ``depth`` deep) whose thresholds are uniform in ``[0,
    thr_max)`` (the default spans the grad_hist value range of noise
    frames, so the trees route both ways), every odd stage from
    ``open_stages`` on rejecting, and the same cascade carried into the
    port with ``model_from_stages`` (on the CPU)."""
    rng = np.random.RandomState(seed)
    opts = dict(shrink=2, n_per_oct=n_per_oct, smooth=smooth,
                channels=channels)
    model = wb.Model(shape, opts)
    for t in range(n_stages):
        s = random_stage(rng, shape[:2], shape[2]) if depth is None \
            else random_deep_stage(rng, shape[:2], shape[2], depth)
        s["threshold"] = rng.uniform(0, thr_max,
                                     len(s["threshold"])).astype("f")
        theta = -0.6 - 0.1 * t if t % 2 and t >= open_stages else -np.inf
        model.append(DTree([tuple(f) for f in s["feature"]], s["threshold"],
                           s["left"], s["right"], s["prediction"]), theta)
    port = wt.model_from_stages(
        model.shape, model.channel_opts,
        [w.to_stage_dict() for w in model.classifier], model.theta,
        device="cpu")
    return model, port


def noise_frames(n, hw, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n,) + tuple(hw)).astype(np.uint8)


def sorted_rows(rects, scores):
    """(N, 5) rows of boxes and scores in lexicographic order."""
    rows = np.concatenate([np.asarray(rects, np.float32).reshape(-1, 4),
                           np.asarray(scores, np.float32).reshape(-1, 1)],
                          axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def port_planes(imgs, packed):
    """(B, 2, 2, Hc, Wc) uint8 planes of a (B, H, W) uint8 numpy batch
    through the port's octave chain and plane kernel (plain on the CPU)."""
    h, w = imgs.shape[1:]
    tables = polyphase.plane_tables(packed, packed.halo, (h, w))
    ops = tpl.PlaneOperands.build(tables, "cpu")
    octs = tpl.octave_buffer(tch.level_octaves(torch.from_numpy(imgs),
                                               len(tables.oct_hw)))
    return tpl.planes(octs, ops)


def port_canvas(imgs, packed, smooth=1):
    """(B, 4, Hc, Wc) float32 grad_hist canvas of a uint8 numpy batch."""
    mask = torch.from_numpy(packed.smooth_interior_mask().astype(np.uint8)) \
        if smooth else None
    return tcc.grad_hist(port_planes(imgs, packed), mask, smooth)
