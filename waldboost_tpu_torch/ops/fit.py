"""Decision-tree fitting from weighted cumulative histograms (plain torch).

Counterpart of ``waldboost_tpu/ops/fit.py`` (``fit_tree_complete``,
``prune_heap_tree``).  The tree is grown as a complete heap-ordered tree of
depth ``max_depth`` (node k's children are 2k+1 and 2k+2); a node with
fewer than ``max(min_samples_leaf, 2)`` samples becomes a leaf.  At each
level the cumulative class masses ``l[c, f, b] = sum_n wc[c, n] * [x_nf <=
edge_bf]`` give every candidate split's entropy gain, and the first maximum
of the (level node, feature, bin) flattening wins, as ``jnp.argmax`` picks
it in JAX.

Binning is JAX's: per-feature quantile edges (the default; thresholds are
data values) taken from a strided subsample of at most 2048 rows of the
padded input, or the uniform grid ``fmin + (b + 1) * width``.  The stride
depends on the padded row count, so callers pad as JAX does.

The split masses are JAX's CPU formulation ("einsum_f32"): a full-float32
product of the class weights with the {0, 1} indicator, in chunks of rows
added in a fixed order, so the indicator never exists whole (stage 0 of
config 4 would need 9.6 GB).  The product runs at full float32 precision
whatever the caller's TF32 setting, restored afterwards; no float atomics
are used, so a fit on the card gives the same bits run after run.  These
sums are in another order than JAX's, so splits can differ only at near
ties.  The leaf masses are float32 sums in sample order on the host, as
JAX adds them; its ``log`` may differ from numpy's by an ULP.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["fit_tree_complete", "TreeFitResult", "prune_heap_tree",
           "full_f32_matmul"]

#: indicator elements per chunk of rows (256 MB of float32)
CHUNK_ELEMS = 1 << 26


class TreeFitResult(NamedTuple):
    feature: torch.Tensor    # (n_nodes,) int32 flat feature index, -1 leaf
    threshold: torch.Tensor  # (n_nodes,) float32
    left: torch.Tensor       # (n_nodes,) int32 (-1 leaf)
    right: torch.Tensor      # (n_nodes,) int32
    pred: torch.Tensor       # (n_nodes,) float32 log-odds


def _fp32_backends(op: str) -> list:
    """The per-backend float32 precision settings of ``op`` (``"matmul"``
    or ``"conv"``): ``fp32_precision`` of ``torch.backends.cuda``'s,
    ``cudnn``'s and ``mkldnn``'s ``op`` where torch has them."""
    found = []
    for parent in (torch.backends.cuda, torch.backends.cudnn,
                   torch.backends.mkldnn):
        b = getattr(parent, op, None)
        if b is not None and hasattr(b, "fp32_precision"):
            found.append(b)
    return found


def _matmul_backends() -> list:
    """The per-backend matmul settings ``torch.set_float32_matmul_precision``
    writes besides its own."""
    return _fp32_backends("matmul")


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products and convolutions at full precision (no
    TF32) inside the block.  On exit the caller's settings come back
    exactly: the value of ``torch.get_float32_matmul_precision`` and the
    per-backend ones, which setting the former also overwrites (a
    per-backend value left changed would clash with a later
    ``allow_tf32`` and make torch refuse to read the precision).  A torch
    without the per-backend convolution setting has its legacy cuDNN flag
    saved and restored instead."""
    prev = torch.get_float32_matmul_precision()
    saved = [(b, b.fp32_precision) for b in _matmul_backends()]
    convs = _fp32_backends("conv")
    saved += [(b, b.fp32_precision) for b in convs]
    legacy = None if convs else torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    for b in convs:
        b.fp32_precision = "ieee"
    if legacy is not None:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        for b, value in saved:
            b.fp32_precision = value
        if legacy is not None:
            torch.backends.cudnn.allow_tf32 = legacy


def _entropy2(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Binary entropy of unnormalized masses, with 0*log(0) = 0."""
    tot = p0 + p1
    tot = torch.where(tot > 0, tot, torch.ones_like(tot))
    q0 = p0 / tot
    q1 = p1 / tot
    one = torch.ones_like(q0)
    zero = torch.zeros_like(q0)
    h0 = torch.where(q0 > 0, -q0 * torch.log2(torch.where(q0 > 0, q0, one)),
                     zero)
    h1 = torch.where(q1 > 0, -q1 * torch.log2(torch.where(q1 > 0, q1, one)),
                     zero)
    return h0 + h1


def _cum_masses(xv: torch.Tensor, edges_t: torch.Tensor, wc: torch.Tensor
                ) -> torch.Tensor:
    """(C2, F, B-1) ``sum_n wc[c, n] * [xv[n, f] <= edges_t[f, b]]`` over
    chunks of rows, each chunk's float32 product added in row order."""
    n, F = xv.shape
    nb = edges_t.shape[1]
    out = torch.zeros((wc.shape[0], F * nb), dtype=torch.float32,
                      device=xv.device)
    chunk = max(1, CHUNK_ELEMS // max(F * nb, 1))
    buf = torch.empty((min(chunk, max(n, 1)), F, nb), dtype=torch.float32,
                      device=xv.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        ind = buf[:e - s]
        torch.le(xv[s:e, :, None], edges_t[None], out=ind)
        out.addmm_(wc[:, s:e], ind.view(e - s, F * nb))
    return out.view(wc.shape[0], F, nb)


def _leaf_predictions(levels: np.ndarray, y: np.ndarray, w: np.ndarray,
                      n_nodes: int) -> np.ndarray:
    """Each node's ``log((w1 + 1e-3) / (w0 + 1e-3)) / 2`` of the raw class
    masses of the samples that reached it (``levels[d]``: every sample's
    node entering level d; padding weighs 0).  The masses are float32 sums
    in sample order, as JAX's ``segment_sum`` adds them on the CPU: on the
    host, because such a sum is serial, and a tree order would differ from
    JAX's by up to 1e-4 relative on a 10,000-sample node."""
    w0 = np.zeros(n_nodes, np.float32)
    w1 = np.zeros(n_nodes, np.float32)
    zero = np.float32(0)
    for d, node in enumerate(levels):
        for k in range(2 ** d - 1, 2 ** (d + 1) - 1):
            here = node == k
            for cls, acc in ((0, w0), (1, w1)):
                v = np.where(here & (y == cls), w, zero)
                acc[k] = np.cumsum(v, dtype=np.float32)[-1] if v.size else 0
    return (np.log((w1 + np.float32(1e-3)) / (w0 + np.float32(1e-3)))
            / np.float32(2.0)).astype(np.float32)


def fit_tree_complete(xf: torch.Tensor, y: torch.Tensor,
                      w_split: torch.Tensor, w_pred: torch.Tensor,
                      valid: torch.Tensor, max_depth: int = 2,
                      n_bins: int = 256, min_samples_leaf: int = 1,
                      feature_mask: Optional[torch.Tensor] = None,
                      binning: str = "quantile") -> TreeFitResult:
    """Fit one complete tree on the device of ``xf``: (N, F) features, (N,)
    int labels {0, 1}, class-balanced split weights, raw weights for the
    leaf predictions, and the (N,) bool mask of real rows (N is the padded
    count).  ``feature_mask``: (max_depth, F) bool features allowed per
    depth."""
    if binning not in ("quantile", "uniform"):
        raise ValueError(f"unknown binning {binning!r}")
    dev = xf.device
    N, F = xf.shape
    B = int(n_bins)
    D = int(max_depth)
    n_nodes = 2 ** (D + 1) - 1
    f32 = torch.float32
    xf = xf.to(f32)
    valid = valid.to(torch.bool)
    y = y.to(torch.int64)
    zero = torch.zeros((), dtype=f32, device=dev)
    w_split = torch.where(valid, w_split.to(f32), zero)
    w_pred = torch.where(valid, w_pred.to(f32), zero)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)

    if binning == "quantile":
        # edges from a strided subsample of the PADDED rows (JAX's stride)
        stride = max(1, -(-N // 2048))
        xsub = xf[::stride]
        vsub = valid[::stride]
        Ns = xsub.shape[0]
        xs = torch.sort(torch.where(vsub[:, None], xsub, inf), dim=0).values
        nv = vsub.sum().to(f32)
        ranks = torch.arange(1, B, dtype=f32, device=dev) * (nv / B)
        idx = torch.clamp(torch.ceil(ranks).to(torch.int64) - 1, 0, Ns - 1)
        edges = xs[idx, :]                                  # (B-1, F)
        edges = torch.where(torch.isfinite(edges), edges,
                            torch.tensor(3e38, dtype=f32, device=dev))
        edges_cmp = edges

        def thr_of(best_f, best_b):
            return edges[torch.clamp(best_b, 0, B - 2), best_f]
    else:
        fmin = torch.where(valid[:, None], xf, inf).amin(dim=0)
        fmax = torch.where(valid[:, None], xf, -inf).amax(dim=0)
        fmin = torch.where(torch.isfinite(fmin), fmin, zero)
        fmax = torch.where(torch.isfinite(fmax), fmax, zero)
        width = torch.clamp((fmax - fmin) / B, min=1e-12)
        edges_cmp = fmin[None, :] + torch.arange(
            1, B, dtype=f32, device=dev)[:, None] * width[None, :]

        def thr_of(best_f, best_b):
            return fmin[best_f] + (best_b + 1).to(f32) * width[best_f]

    # the masses are sums over real rows only (padding weighs 0)
    rows = torch.nonzero(valid)[:, 0]
    xv = xf[rows]
    wsv = w_split[rows]
    edges_t = edges_cmp.t().contiguous()                    # (F, B-1)

    feature = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros(n_nodes, dtype=f32, device=dev)
    left = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)
    right = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    levels = []    # each sample's node as it enters each level
    for d in range(D):
        n_level = 2 ** d
        base = n_level - 1
        levels.append(node)
        at_level = (node >= base) & valid
        local = torch.where(at_level, node - base,
                            torch.full_like(node, n_level))
        # class rows of the product: 2 * local node + label
        cls = (local * 2 + y)[rows]
        slots = torch.arange(2 * n_level, device=dev)
        wc = torch.where(cls[None, :] == slots[:, None], wsv[None, :], zero)
        with full_f32_matmul():
            l_part = _cum_masses(xv, edges_t, wc)           # (C2, F, B-1)
        tot_c = wc.sum(dim=1)
        l_all = torch.cat([l_part, tot_c[:, None, None].expand(-1, F, 1)],
                          dim=-1).view(n_level, 2, F, B)
        l0 = l_all[:, 0].permute(1, 0, 2)                   # (F, n_level, B)
        l1 = l_all[:, 1].permute(1, 0, 2)
        l0_tot = l0[..., -1:]
        l1_tot = l1[..., -1:]
        r0 = l0_tot - l0
        r1 = l1_tot - l1
        tot = l0_tot + l1_tot
        tot_safe = torch.where(tot > 0, tot, torch.ones_like(tot))
        left_w = (l0 + l1) / tot_safe
        right_w = (r0 + r1) / tot_safe
        gain = _entropy2(l0_tot, l1_tot) - (
            left_w * _entropy2(l0 + 1e-4, l1 + 1e-4)
            + right_w * _entropy2(r0 + 1e-4, r1 + 1e-4))
        gain[..., B - 1] = float("-inf")   # empty right side
        if feature_mask is not None:
            gain = torch.where(feature_mask[d].to(dev)[:, None, None], gain,
                               -inf)
        flat = gain.permute(1, 0, 2).reshape(n_level, F * B)
        best = torch.argmax(flat, dim=1)
        best_f = best // B
        best_b = best % B
        best_thr = thr_of(best_f, best_b)

        # a node needs at least 2 samples to split (min_samples_split)
        lvl = torch.arange(n_level, device=dev)
        cnt = (at_level[None, :] & (local[None, :] == lvl[:, None])).sum(1)
        make_leaf = cnt < max(int(min_samples_leaf), 2)
        ids = base + lvl
        feature[ids] = torch.where(make_leaf, -1, best_f).to(torch.int32)
        threshold[ids] = torch.where(make_leaf, zero, best_thr)
        left[ids] = torch.where(make_leaf, -1, 2 * ids + 1).to(torch.int32)
        right[ids] = torch.where(make_leaf, -1, 2 * ids + 2).to(torch.int32)

        # route the samples of this level's inner nodes
        li = torch.clamp(local, 0, n_level - 1)
        xval = torch.gather(xf, 1, best_f[li][:, None])[:, 0]
        child = 2 * node + 1 + (xval > best_thr[li]).to(torch.int64)
        node = torch.where(at_level & ~make_leaf[li], child, node)

    levels.append(node)
    pred = torch.from_numpy(_leaf_predictions(
        torch.stack(levels).cpu().numpy(), y.cpu().numpy(),
        w_pred.cpu().numpy(), n_nodes)).to(dev)
    return TreeFitResult(feature=feature, threshold=threshold, left=left,
                         right=right, pred=pred)


def prune_heap_tree(feature: np.ndarray, threshold: np.ndarray,
                    left: np.ndarray, right: np.ndarray, pred: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, np.ndarray]:
    """Drop unreachable heap nodes (children of early leaves) and renumber
    in BFS order (host numpy)."""
    feature = np.asarray(feature)
    order = []
    remap = {}
    queue = [0]
    while queue:
        k = queue.pop(0)
        remap[k] = len(order)
        order.append(k)
        if left[k] >= 0:
            queue.append(int(left[k]))
            queue.append(int(right[k]))
    idx = np.array(order, int)
    new_left = np.array([remap[int(v)] if v >= 0 else -1 for v in left[idx]],
                        np.int32)
    new_right = np.array([remap[int(v)] if v >= 0 else -1
                          for v in right[idx]], np.int32)
    return (feature[idx].astype(np.int32), threshold[idx].astype(np.float32),
            new_left, new_right, pred[idx].astype(np.float32))
