"""One boosting stage over the device-resident padded pools, on the card.

Counterpart of ``waldboost_tpu/parallel/train_step.py``.  A stage reads
the two fixed-capacity pools (samples ``x``, scores ``H``, validity ``v``
of the negatives and the positives) where they lie and does every numeric
step there: exp-loss weights, the class-balanced histogram tree fit
(:func:`~waldboost_tpu_torch.ops.fit.fit_tree_complete`), the FPGA
transforms, the score update, the SPRT threshold, the stage statistics and
the pruning of rejected samples.  The pools never leave the device; the
host reads the tree tables and a few scalars once per stage.

The JAX module builds one jitted program per parameter set (memoized) and
chooses among XLA formulations of the fit's histograms (``hist_mode``,
``WB_HIST_*``); the port runs the same steps eagerly with its one
formulation.

Under a mesh (:mod:`.mesh`) the pools are sharded at rest.  A stage
gathers ``x``, ``H`` and ``v`` of both pools in global slot order on the
process's first mesh device, runs the unsharded stage there (every
process computes the same replicated result), and writes the updated
scores and validity back as shards.  The statistics are then the
unsharded step's, bitwise, at every mesh size and process layout:
partial sums reduced per shard would round differently for each mesh
and flip near-tie splits, so none are taken.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.fit import TreeFitResult, fit_tree_complete
from ..training import fit_rejection_threshold_device
from .mesh import as_shards, gather, shard_array

__all__ = ["StageResult", "make_train_step", "tree_predict_device"]


class StageResult(NamedTuple):
    tree: TreeFitResult
    theta: torch.Tensor  # () float32
    H0: torch.Tensor     # updated scores (padded)
    H1: torch.Tensor
    p0: torch.Tensor     # () float32
    p1: torch.Tensor
    loss: torch.Tensor
    v0: torch.Tensor     # post-stage validity masks (SPRT-pruned pools)
    v1: torch.Tensor
    n0: torch.Tensor     # () int32 post-prune pool counts
    n1: torch.Tensor


def tree_predict_device(tree: TreeFitResult, xf: torch.Tensor,
                        max_depth: int) -> torch.Tensor:
    """Evaluate a heap-layout tree on flattened samples (N, F) -> (N,)."""
    node = torch.zeros(xf.shape[0], dtype=torch.int64, device=xf.device)
    feature = tree.feature.to(torch.int64)
    for _ in range(max_depth):
        f = feature[node]
        fv = torch.gather(xf, 1, f.clamp(min=0)[:, None])[:, 0]
        child = 2 * node + 1 + (fv > tree.threshold[node]).to(torch.int64)
        node = torch.where(f < 0, node, child)
    return tree.pred[node]


def _scalar(value, device) -> torch.Tensor:
    """A 0-dim float32 tensor of ``value`` on ``device`` (a fill, no
    host-to-device copy)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def _stage_body(x0, H0, v0, x1, H1, v1, P0, P1, theta_in, use_sprt,
                feature_mask=None, alpha=0.1, max_depth=2, n_bins=256,
                min_samples_leaf=1, clip=None, quantizer=None,
                integer_thresholds=False, binning="quantile"):
    """x0/x1: (N?, F) flattened padded pools on one device; H: scores; v:
    valid masks.  ``theta_in``/``use_sprt``: the rejection schedule's
    override (``use_sprt`` true: estimate theta from the data)."""
    dev = x0.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    n0 = torch.clamp(v0.sum(), min=1).to(f32)
    n1 = torch.clamp(v1.sum(), min=1).to(f32)
    # exp-loss weights over the valid rows
    W0 = torch.where(v0, torch.exp(H0), zero) / n0 / 2
    W1 = torch.where(v1, torch.exp(-H1), zero) / n1 / 2

    xf = torch.cat([x0, x1])
    y = torch.cat([torch.zeros(x0.shape[0], dtype=torch.int32, device=dev),
                   torch.ones(x1.shape[0], dtype=torch.int32, device=dev)])
    w = torch.cat([W0, W1])
    valid = torch.cat([v0, v1])
    # class-balanced split weights (each class sums to 0.5)
    s0 = torch.clamp(W0.sum(), min=1e-30)
    s1 = torch.clamp(W1.sum(), min=1e-30)
    wb = torch.cat([W0 / (s0 * 2), W1 / (s1 * 2)])

    if feature_mask is not None:
        feature_mask = torch.as_tensor(feature_mask).to(dev, torch.bool)
    tree = fit_tree_complete(xf, y, wb, w, valid, max_depth=max_depth,
                             n_bins=n_bins, min_samples_leaf=min_samples_leaf,
                             feature_mask=feature_mask, binning=binning)
    # FPGA mode: integer-floored thresholds and clipped, quantized
    # responses BEFORE score accumulation
    if integer_thresholds:
        tree = tree._replace(threshold=torch.floor(tree.threshold))
    pred = tree.pred
    if clip is not None:
        pred = torch.clamp(pred, -float(clip), float(clip))
    if quantizer:
        q = _scalar(quantizer, dev)
        pred = torch.round(q * pred) / q
    tree = tree._replace(pred=pred)

    H0n = H0 + tree_predict_device(tree, x0, max_depth)
    H1n = H1 + tree_predict_device(tree, x1, max_depth)

    if bool(use_sprt):
        theta = fit_rejection_threshold_device(
            H0n, H1n, _scalar(P0, dev), _scalar(P1, dev), alpha, v0=v0,
            v1=v1)
    else:
        theta = _scalar(theta_in, dev)

    # SPRT pruning: rejected samples leave the pool
    v0n = v0 & (H0n >= theta)
    v1n = v1 & (H1n >= theta)
    loss = (torch.where(v0, torch.exp(H0n), zero).sum() / n0
            + torch.where(v1, torch.exp(-H1n), zero).sum() / n1) / 2
    return StageResult(tree=tree, theta=theta, H0=H0n, H1=H1n,
                       p0=v0n.sum() / n0, p1=v1n.sum() / n1,
                       loss=loss, v0=v0n, v1=v1n,
                       n0=v0n.sum(dtype=torch.int32),
                       n1=v1n.sum(dtype=torch.int32))


def make_train_step(alpha: float = 0.1, max_depth: int = 2, n_bins: int = 256,
                    min_samples_leaf: int = 1, mesh=None, clip=None,
                    quantizer=None, integer_thresholds: bool = False,
                    binning: str = "quantile"):
    """The stage-training step:

        step(x0, H0, v0, x1, H1, v1, P0, P1, theta_in, use_sprt,
             feature_mask=None) -> StageResult

    on the device of ``x0``.  ``P0``/``P1`` are the learner's cumulative
    rates and ``theta_in`` the schedule's threshold (numbers, used as
    float32); ``feature_mask``: optional (max_depth, F) bool allowed split
    features per depth (the FPGA bank restriction).  ``clip``,
    ``quantizer`` and ``integer_thresholds`` apply the FPGA transforms
    in-step.

    With ``mesh`` the pool arguments are lists of this process's shards
    (or full tensors, which are sharded first); the result's ``H0``,
    ``H1``, ``v0`` and ``v1`` are lists of shards, the rest lies on the
    process's first mesh device.
    """
    body = functools.partial(
        _stage_body, alpha=alpha, max_depth=max_depth, n_bins=n_bins,
        min_samples_leaf=min_samples_leaf, clip=clip, quantizer=quantizer,
        integer_thresholds=integer_thresholds, binning=binning)
    if mesh is None:
        return body

    def step(x0, H0, v0, x1, H1, v1, *args):
        pools = [gather(as_shards(a, mesh), mesh)
                 for a in (x0, H0, v0, x1, H1, v1)]
        res = body(*pools, *args)
        return res._replace(**{
            f: shard_array(getattr(res, f), mesh, mesh.axis_name)
            for f in ("H0", "H1", "v0", "v1")})

    return step
