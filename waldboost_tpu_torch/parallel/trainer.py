"""Training loop with a fixed-capacity sample pool that stays on the card.

Counterpart of ``waldboost_tpu/parallel/trainer.py`` (BASELINE config
4b).  Each class of the sample pool lives on the device as fixed-capacity
buffers with a validity mask (:class:`DevicePool`).  Per stage the host
refills the pools by mining (``samples.mine_labeled_windows``: B1, B2 or
B5, B6 on the card; the kept windows' crops are gathered into free pool
slots there, never copied to the host), then one stage step
(:mod:`.train_step`) does every numeric step on the device, and the host
reads the tree tables and the stage's scalars in one copy.

While a torch profiler runs, the loop runs in ``wb.train.*`` spans:
``insert`` (crops into the pools) and ``step`` (the stage step), besides
mining's ``mine`` and ``label``.

Under a mesh (:mod:`.mesh`) each pool is sharded at rest: each mesh
device holds ``capacity / n`` slots, and the stage step gathers them
(:mod:`.train_step`).  Mining runs on the model's device, which in a
mesh run is the process's first mesh device; each process mines the same
seeded stream, and copies the kept rows whose slots fall in its own
shards straight from the mining device to the shard's device (the JAX
package stages them through the host on a multi-process mesh).

The JAX module's compile prewarming serves XLA; the port compiles
nothing.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..canvas import span
from ..device import resolve_device
from ..ops.fit import prune_heap_tree
from ..samples import SampleLabel, batched_records, mine_labeled_windows
from ..training import BasicRejectionSchedule, DTree, Learner
from .mesh import Mesh, gather
from .train_step import make_train_step

__all__ = ["DevicePool", "train_sharded"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DevicePool:
    """One class (tp or fp) of the device-resident sample pool: ``x``
    (capacity, F) float32 samples, ``H`` scores and ``v`` validity on
    ``device`` (the card when None); ``count`` is the host mirror of
    ``sum(v)``.  With ``mesh``, ``x``, ``H`` and ``v`` are lists of this
    process's shards, ``capacity / mesh.size`` slots each, in global slot
    order; ``device`` is then the process's first mesh device.  The
    capacity is rounded up to 256 slots whatever the mesh, so the slots,
    and the trained model, do not depend on it."""

    def __init__(self, capacity: int, feat_dim: int, device=None,
                 mesh: Optional[Mesh] = None):
        n = 1 if mesh is None else mesh.size
        self.capacity = _round_up(capacity, 256)
        if self.capacity % n:
            raise ValueError(f"the mesh size {n} must divide the pool's "
                             f"{self.capacity} slots")
        self.mesh = mesh
        self.feat_dim = feat_dim
        self.device = resolve_device(device) if mesh is None \
            else mesh.local_devices[0]
        devices = [self.device] if mesh is None else mesh.local_devices
        per = self.capacity // n
        z = lambda *s, dt: [torch.zeros(s, dtype=dt, device=d)
                            for d in devices]
        self.x = z(per, feat_dim, dt=torch.float32)
        self.H = z(per, dt=torch.float32)
        self.v = z(per, dt=torch.bool)
        if mesh is None:
            self.x, self.H, self.v = self.x[0], self.H[0], self.v[0]
        self.count = 0

    def _put(self, xn: torch.Tensor, Hn: torch.Tensor) -> None:
        """Rows ``xn``/``Hn`` into the first free slots in global index
        order (a stable sort of ``v`` puts them first); occupied slots are
        never overwritten."""
        if self.mesh is not None:
            return self._put_sharded(xn, Hn)
        k = xn.shape[0]
        slots = torch.sort(self.v.to(torch.uint8), stable=True).indices[:k]
        free = ~self.v[slots]
        self.x[slots] = torch.where(free[:, None], xn, self.x[slots])
        self.H[slots] = torch.where(free, Hn, self.H[slots])
        self.v[slots] = True

    def _put_sharded(self, xn: torch.Tensor, Hn: torch.Tensor) -> None:
        """:meth:`_put` over the shards: the slots come from the gathered
        ``v`` (all free: callers accept at most ``capacity - count``
        rows), and each of this process's shards takes the rows whose
        slots it holds, copied from ``xn``'s device to its own."""
        mesh = self.mesh
        v = gather(self.v, mesh, xn.device)
        slots = torch.sort(v.to(torch.uint8), stable=True).indices[
            :xn.shape[0]].cpu().numpy()
        per = self.capacity // mesh.size
        for i, d in enumerate(mesh.local_devices):
            lo = (mesh.local_start + i) * per
            rows = np.flatnonzero((slots >= lo) & (slots < lo + per))
            if rows.size == 0:
                continue
            src = torch.from_numpy(rows).to(xn.device)
            dst = torch.from_numpy(slots[rows] - lo).to(d)
            self.x[i][dst] = xn[src].to(d)
            self.H[i][dst] = Hn[src].to(d)
            self.v[i][dst] = True

    def insert(self, X_new, H_new) -> int:
        """Insert host-mined crops; returns how many were accepted."""
        k = int(len(X_new))
        accept = min(k, self.capacity - self.count)
        if accept <= 0:
            return 0
        F = self.feat_dim
        X_new = np.asarray(X_new, np.float32).reshape(k, F)[:accept]
        H_new = np.asarray(H_new, np.float32).ravel()[:accept]
        self._put(torch.from_numpy(np.ascontiguousarray(X_new)).to(
                      self.device),
                  torch.from_numpy(np.ascontiguousarray(H_new)).to(
                      self.device))
        self.count += accept
        return accept

    def insert_from_device(self, src_x: torch.Tensor, src_H: torch.Tensor,
                           idx) -> int:
        """Insert rows ``idx`` of on-device mined crops (K, ...) and scores
        (K,), gathered on the device; the slots are those sequential
        :meth:`insert` calls over the same rows would fill."""
        k = int(len(idx))
        accept = min(k, self.capacity - self.count)
        if accept <= 0:
            return 0
        idx = torch.from_numpy(np.ascontiguousarray(idx[:accept], np.int64))
        idx = idx.to(src_x.device)
        # under a mesh the rows go from the mining device to each shard's
        dev = self.device if self.mesh is None else src_x.device
        self._put(src_x[idx].reshape(accept, -1).to(dev, torch.float32),
                  src_H[idx].to(dev, torch.float32))
        self.count += accept
        return accept

    def apply_stage(self, H, v, count: int) -> None:
        """Adopt a stage's scores, pruned validity mask (shards under a
        mesh) and its ``sum(v)`` as read on the host (``x`` is unchanged by
        a stage)."""
        self.H = H
        self.v = v
        self.count = int(count)


def _fetch(res):
    """The stage's tree tables, theta, p0, p1, loss, n0 and n1 on the host
    in ONE device-to-host copy (float32 values travel as their bits)."""
    t = res.tree
    i32 = torch.int32
    k = t.feature.numel()
    scal = torch.stack([res.theta, res.p0, res.p1, res.loss]).to(
        torch.float32)
    flat = torch.cat([t.feature.to(i32), t.left.to(i32), t.right.to(i32),
                      t.threshold.contiguous().view(i32),
                      t.pred.contiguous().view(i32), scal.view(i32),
                      torch.stack([res.n0, res.n1]).to(i32)]).cpu().numpy()
    feature, left, right, thr, pred, scal, counts = np.split(
        flat, np.cumsum([k, k, k, k, k, 4]))
    theta, p0, p1, loss = scal.view(np.float32)
    tree = (feature, thr.view(np.float32), left, right, pred.view(np.float32))
    return tree, theta, p0, p1, loss, int(counts[0]), int(counts[1])


def _dtree_from_fit(tree, shape) -> DTree:
    """Heap-layout host tables ``(feature, threshold, left, right, pred)``
    -> a host :class:`DTree` (unreachable nodes pruned)."""
    feature, thr, left, right, pred = tree
    feat, thr, left, right, pred = prune_heap_tree(feature, thr, left, right,
                                                   pred)
    return DTree([np.unravel_index(f, shape) if f >= 0 else None
                  for f in feat], thr, left, right, pred)


def train_sharded(model, training_images, mesh=None, learner: Learner = None,
                  length: int = 64, min_tp: int = 1000, min_fp: int = 1000,
                  capacity: Optional[int] = None, theta_schedule=None,
                  max_depth: int = 2, n_bins: int = 256,
                  binning: str = "quantile", seed=None,
                  callbacks=(), logger: Optional[logging.Logger] = None,
                  mine_batch: int = 8, feature_masks_fn=None,
                  clip=None, quantizer=None,
                  integer_thresholds: bool = False, pools: dict = None,
                  prewarm_length: Optional[int] = None, **label_kwargs):
    """Train ``model`` to ``length`` stages with the device-resident pool,
    on the model's device.  Returns the Learner.

    Semantics of ``wt.train`` (pool bootstrap, exp-loss boosting, SPRT
    thresholds, the rejection schedule, Learner statistics) with the
    histogram tree fit on the padded pools.  ``capacity`` (default twice
    the larger quota, rounded up to 256) is each class's slot count.

    ``feature_masks_fn(stage) -> (max_depth, F) bool``: per-stage allowed
    split features per depth (the FPGA bank restriction);
    ``clip``/``quantizer``/``integer_thresholds`` apply the FPGA response
    and threshold transforms in-step, before score accumulation.

    ``pools``: an optional mutable dict carrying the device pools across
    calls (``{"fp": DevicePool, "tp": DevicePool}``, filled in on first
    use).  A call with the same dict and model continues from the mined
    and rescored pools; a different model, or one grown or cut outside
    this function, re-bootstraps them.

    ``prewarm_length`` is accepted and does nothing: the JAX trainer
    starts its mining programs' compiles with it, and the port compiles
    nothing.

    ``mesh`` shards the pools over its devices (see :mod:`.trainer`);
    the trained model is the unsharded run's, bitwise, at every mesh size
    and process layout.  Mining runs on the model's device: make it the
    process's first mesh device.
    """
    logger = logger or logging.getLogger("Training")
    if len(model) >= length:
        return learner
    learner = learner or Learner(alpha=0.2, max_depth=max_depth)
    if len(model) != len(learner):
        raise RuntimeError("Model length and learner length are not "
                           "consistent")
    if theta_schedule is None:
        theta_schedule = BasicRejectionSchedule()

    dev = model.device
    m, n, C = model.shape
    F = m * n * C
    capacity = capacity or 2 * max(min_tp, min_fp)
    pool_fp = pool_tp = None
    if pools is not None:
        pool_fp, pool_tp = pools.get("fp"), pools.get("tp")
        # carried scores are valid only for the SAME model object at the
        # stage count it had when the previous call returned
        tag = (id(model), len(model), F, mesh)
        if pool_fp is not None and pools.get("model_tag") != tag:
            logger.info("pools carry-over rejected (model, stage count or "
                        "mesh changed): re-bootstrapping the device pool")
            pool_fp = pool_tp = None
        if pool_fp is not None and pool_fp.capacity < _round_up(capacity,
                                                                256):
            logger.warning(
                "pools carry-over keeps the previous capacity %d; the "
                "requested capacity %d is ignored", pool_fp.capacity,
                capacity)
    if pool_fp is None or pool_tp is None:
        pool_fp = DevicePool(capacity, F, device=dev, mesh=mesh)
        pool_tp = DevicePool(capacity, F, device=dev, mesh=mesh)
    if pools is not None:
        pools["fp"], pools["tp"] = pool_fp, pool_tp
    rng = np.random.default_rng(seed)
    step = make_train_step(alpha=learner.alpha, max_depth=max_depth,
                           n_bins=n_bins, binning=binning, mesh=mesh,
                           clip=clip, quantizer=quantizer,
                           integer_thresholds=integer_thresholds)
    it = iter(training_images)

    def refill():
        need_tp = pool_tp.count < min_tp
        need_fp = pool_fp.count < min_fp
        if not (need_tp or need_fp):
            return
        mined = 0
        for group in batched_records(it, mine_batch):
            res = mine_labeled_windows(model, group, tp=need_tp, fp=need_fp,
                                       rng=rng, **label_kwargs)
            if res is not None:
                pend, samples_dev, scores_dev = res
                label = np.concatenate(
                    [b.get_field("tp_label") for _, b in pend])
                tp_idx = np.flatnonzero(label == SampleLabel.TRUE_POSITIVE)
                fp_idx = np.flatnonzero(label == SampleLabel.FALSE_POSITIVE)
                with span("wb.train.insert"):
                    if need_tp and tp_idx.size:
                        pool_tp.insert_from_device(samples_dev, scores_dev,
                                                   tp_idx)
                    if need_fp and fp_idx.size:
                        pool_fp.insert_from_device(samples_dev, scores_dev,
                                                   fp_idx)
            mined += len(group)
            need_tp = pool_tp.count < min_tp
            need_fp = pool_fp.count < min_fp
            if not (need_tp or need_fp) or mined >= 10000:
                return
        if need_tp or need_fp:
            logger.warning("training images exhausted during mining")

    for stage in range(len(model), length):
        refill()
        logger.log(15, f"Stage {stage}: pool tp={pool_tp.count} "
                       f"fp={pool_fp.count}")
        theta_in = theta_schedule(stage, learner.false_positive_rate)
        use_sprt = theta_in is None
        fmask = (None if feature_masks_fn is None
                 else np.asarray(feature_masks_fn(stage), bool))
        with span("wb.train.step"):
            res = step(pool_fp.x, pool_fp.H, pool_fp.v,
                       pool_tp.x, pool_tp.H, pool_tp.v,
                       learner.false_positive_rate,
                       learner.true_positive_rate,
                       -np.inf if use_sprt else theta_in, use_sprt, fmask)
            tree_h, theta, p0, p1, loss, c0, c1 = _fetch(res)
        theta = float(theta)
        model.append(_dtree_from_fit(tree_h, (m, n, C)), theta)
        learner.record_stage(p0, p1, loss)
        pool_fp.apply_stage(res.H0, res.v0, count=c0)
        pool_tp.apply_stage(res.H1, res.v1, count=c1)
        logger.log(15, f"Stage {stage}: loss {float(loss):g} "
                       f"p0 {float(p0):g} p1 {float(p1):g} "
                       f"theta {theta:g}")
        for cb in callbacks:
            cb(model, learner, stage)
    if pools is not None:
        pools["model_tag"] = (id(model), len(model), F, mesh)
    return learner
