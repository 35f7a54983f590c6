"""WaldBoost training: weak trees, the boosting learner, SPRT thresholds.

Counterpart of ``waldboost_tpu/training.py``:

* :class:`DTree`: a flat-array decision tree (the model file's DTree
  message).  ``DTree.fit`` fits on a device with the weighted-histogram
  splitter of :mod:`waldboost_tpu_torch.ops.fit` (``backend="hist"``, the
  default) or with scikit-learn's CART (``backend="sklearn"``, imported at
  the call; not installed on every machine).
* :class:`Learner`: one boosting stage per ``fit_stage``: exp-loss weights,
  the weak fit, score update, SPRT threshold, p0/p1/loss, pickle
  checkpoints (JAX-written ones load too, without importing JAX).
* :func:`fit_rejection_threshold` (host, float64 numpy, JAX's code) and
  :func:`fit_rejection_threshold_device` (torch, float32, fixed shapes).
* :class:`BasicRejectionSchedule`.

Host arithmetic (weights, class balancing, pruning, the host SPRT) is the
JAX package's numpy code, so it gives JAX's bits.
"""

from __future__ import annotations

import importlib
import logging
import pickle
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .canvas import span
from .device import resolve_device
from .ops.fit import fit_tree_complete, prune_heap_tree

logger = logging.getLogger(__name__)

__all__ = [
    "weights",
    "as_features",
    "DTree",
    "Learner",
    "StageRecord",
    "loss",
    "fit_rejection_threshold",
    "fit_rejection_threshold_device",
    "BasicRejectionSchedule",
]


def weights(H: np.ndarray) -> np.ndarray:
    """Exponential-loss sample weights."""
    H = np.asarray(H)
    return np.exp(H) / H.size / 2


def as_features(X: np.ndarray) -> np.ndarray:
    """(N, ...) samples as (N, F) rows (F explicit, so N may be 0)."""
    X = np.asarray(X)
    n = X.shape[0]
    f = int(np.prod(X.shape[1:])) if X.ndim > 1 else 0
    return X.reshape(n, f)


class DTree:
    """Flat-array decision tree weak classifier.

    Node ``k`` tests ``X[r, c, ch] <= threshold[k]`` with the feature triple
    ``feature[k]``; ``left``/``right`` are child indices (-1 at leaves);
    ``prediction`` holds each node's log-odds.  Leaves carry ``(0, 0, 0)``
    features.
    """

    def __init__(self, feature, threshold, left, right, prediction):
        self.feature = np.array(
            [f if f is not None else (0, 0, 0) for f in feature], np.int32
        ).reshape(-1, 3)
        self.threshold = np.asarray(threshold, np.float32).reshape(-1)
        self.left = np.asarray(left, np.int32).reshape(-1)
        self.right = np.asarray(right, np.int32).reshape(-1)
        self.prediction = np.asarray(prediction, np.float32).reshape(-1)
        self.node = self.left >= 0
        self.node_idx = np.flatnonzero(self.node)

    # -- training -----------------------------------------------------------
    @staticmethod
    def fit(X0, W0, X1, W1, max_depth: int = 2, min_samples_leaf: int = 1,
            allowed_features=None, backend: str = "hist", n_bins: int = 256,
            binning: str = "quantile",
            clip: Optional[float] = None, quantizer: Optional[int] = None,
            integer_thresholds: bool = False, device=None,
            **sklearn_args) -> "DTree":
        """Fit a weak tree on weighted negatives (X0, W0) and positives
        (X1, W1).

        ``backend="hist"``: the histogram splitter on ``device`` (the card
        when None).  ``backend="sklearn"``: scikit-learn's CART with
        balanced class weights, on the host.
        ``allowed_features``: optional per-depth lists of flat feature
        indices (the FPGA bank restriction).  ``clip``/``quantizer``:
        optional leaf clipping and quantization ``round(q * p) / q``.
        ``integer_thresholds``: floor the thresholds (exact for
        integer-valued channels; FPGA mode).
        """
        if backend == "sklearn":
            tree = DTree._fit_sklearn(X0, W0, X1, W1, max_depth=max_depth,
                                      min_samples_leaf=min_samples_leaf,
                                      **sklearn_args)
        elif backend == "hist":
            tree = DTree._fit_hist(X0, W0, X1, W1, max_depth=max_depth,
                                   min_samples_leaf=min_samples_leaf,
                                   allowed_features=allowed_features,
                                   n_bins=n_bins, binning=binning,
                                   device=device)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        if integer_thresholds:
            # for integer-valued features a threshold in (k, k+1) and k
            # split alike, and k is what integer hardware compares
            tree.threshold = np.floor(tree.threshold)
        if clip is not None:
            tree.prediction = np.clip(tree.prediction, -clip, clip)
        if quantizer is not None:
            tree.prediction = np.round(quantizer * tree.prediction) / quantizer
        return tree

    @staticmethod
    def _fit_hist(X0, W0, X1, W1, max_depth, min_samples_leaf,
                  allowed_features, n_bins, binning="quantile",
                  device=None) -> "DTree":
        dev = resolve_device(device)
        X0 = np.asarray(X0)
        X1 = np.asarray(X1)
        shape = X0.shape[1:]
        F = int(np.prod(shape))
        X = np.concatenate([as_features(X0), as_features(X1)]).astype(np.float32)
        Y = np.concatenate([np.zeros(len(X0), np.int32),
                            np.ones(len(X1), np.int32)])
        W = np.concatenate([np.asarray(W0, np.float32),
                            np.asarray(W1, np.float32)])
        # class-balanced split weights: each class sums to 0.5
        Wb = W.copy()
        s0 = Wb[Y == 0].sum()
        s1 = Wb[Y == 1].sum()
        if s0 > 0:
            Wb[Y == 0] /= s0 * 2
        if s1 > 0:
            Wb[Y == 1] /= s1 * 2
        N = X.shape[0]
        # the padded count is part of the fit: the quantile edges' stride
        # is ceil(Np / 2048) (JAX pads to these sizes for its jit cache)
        Np = max(256, 1 << (max(N, 1) - 1).bit_length())
        pad = Np - N
        valid = torch.zeros(Np, dtype=torch.bool, device=dev)
        valid[:N] = True

        def up(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return torch.nn.functional.pad(t, (0, 0, 0, pad) if t.dim() == 2
                                           else (0, pad))

        fmask = None
        if allowed_features is not None:
            fm = np.zeros((max_depth, F), bool)
            for d in range(max_depth):
                fm[d, np.asarray(allowed_features[d], int)] = True
            fmask = torch.from_numpy(fm).to(dev)

        res = fit_tree_complete(
            up(X), up(Y), up(Wb), up(W), valid, max_depth=int(max_depth),
            n_bins=int(n_bins), min_samples_leaf=int(min_samples_leaf),
            feature_mask=fmask, binning=binning)
        feat, thr, left, right, pred = prune_heap_tree(
            *(t.cpu().numpy() for t in res))
        feature = [np.unravel_index(f, shape) if f >= 0 else None
                   for f in feat]
        return DTree(feature, thr, left, right, pred)

    @staticmethod
    def _fit_sklearn(X0, W0, X1, W1, max_depth=2, min_samples_leaf=1,
                     **kwargs) -> "DTree":
        from sklearn.tree import DecisionTreeClassifier
        X = np.concatenate([as_features(X0), as_features(X1)])
        Y = np.array([0] * len(X0) + [1] * len(X1))
        W = np.concatenate([np.asarray(W0), np.asarray(W1)])
        T = DecisionTreeClassifier(class_weight="balanced",
                                   max_depth=max_depth,
                                   min_samples_leaf=min_samples_leaf,
                                   **kwargs)
        T.fit(X, Y, sample_weight=W)
        shape = X0.shape[1:]
        tree = T.tree_
        feature = [np.unravel_index(f, shape) if f >= 0 else None
                   for f in tree.feature]
        leaf = T.apply(X)
        pred = np.empty(tree.node_count)
        for k in range(tree.node_count):
            mask = leaf == k
            w0 = (W * mask * (Y == 0)).sum() + 1e-3
            w1 = (W * mask * (Y == 1)).sum() + 1e-3
            pred[k] = np.log(w1 / w0) / 2
        return DTree(feature, tree.threshold, tree.children_left,
                     tree.children_right, pred)

    # -- inference (host) ---------------------------------------------------
    def apply(self, X) -> np.ndarray:
        """The node each (N, m, n, C) sample ends in."""
        X = np.asarray(X)
        node = np.zeros(X.shape[0], np.int64)
        for k in self.node_idx:
            r, c, ch = self.feature[k]
            idx = np.flatnonzero(node == k)
            if idx.size == 0:
                continue
            go_left = X[idx, r, c, ch] <= self.threshold[k]
            node[idx] = np.where(go_left, self.left[k], self.right[k])
        return node

    def predict(self, X) -> np.ndarray:
        return self.prediction[self.apply(X)]

    def predict_on_image(self, X, rs, cs) -> np.ndarray:
        """Responses of the windows at origins (rs, cs) of an HWC image."""
        X = np.asarray(X)
        node = np.zeros(rs.size, np.int64)
        for k in self.node_idx:
            r, c, ch = self.feature[k]
            idx = np.flatnonzero(node == k)
            if idx.size == 0:
                continue
            go_left = X[rs[idx] + r, cs[idx] + c, ch] <= self.threshold[k]
            node[idx] = np.where(go_left, self.left[k], self.right[k])
        return self.prediction[node]

    # -- conversion ----------------------------------------------------------
    def to_stage_dict(self) -> dict:
        """The stage dict :meth:`Model.append` and the cascade tables take."""
        feature = self.feature.copy()
        feature[self.left < 0] = 0
        return dict(feature=feature, threshold=self.threshold,
                    left=self.left, right=self.right,
                    prediction=self.prediction)

    @staticmethod
    def from_proto(msg: dict) -> "DTree":
        """A tree from the fields of a decoded DTree message
        (:mod:`waldboost_tpu_torch.model_io`)."""
        ftr = np.asarray(msg["feature"], np.int32).reshape(-1, 3)
        feature = [tuple(x) if x[0] >= 0 else None for x in ftr]
        return DTree(feature, np.asarray(msg["threshold"]),
                     np.asarray(msg["left"]), np.asarray(msg["right"]),
                     np.asarray(msg["prediction"]))

    def as_proto(self) -> dict:
        """The DTree message fields of this tree (leaf features as -1
        triples), as :mod:`waldboost_tpu_torch.model_io` encodes them."""
        feature = self.feature.copy()
        feature[self.left < 0] = -1
        return dict(feature=feature.reshape(-1),
                    threshold=self.threshold.copy(), left=self.left.copy(),
                    right=self.right.copy(),
                    prediction=self.prediction.copy())


def loss(H0, H1) -> float:
    """Exp-loss of the current scores; an empty class contributes 0."""
    W0 = weights(H0)
    W1 = weights(-np.asarray(H1))
    m0 = float(W0.mean()) if W0.size else 0.0
    m1 = float(W1.mean()) if W1.size else 0.0
    return m0 + m1


class _InteropUnpickler(pickle.Unpickler):
    """Unpickler that resolves the JAX package's and the reference's
    globals in this package.

    Learner checkpoints name their weak-learner class by module path:
    ``waldboost_tpu.training.DTree`` (the JAX package) or
    ``waldboost.training.DTree`` (the reference).  Both map onto
    ``waldboost_tpu_torch``; a name with no counterpart here raises rather
    than importing the JAX package (which would import jax)."""

    _PREFIXES = ("waldboost_tpu", "waldboost")

    def find_class(self, module, name):
        for prefix in self._PREFIXES:
            if module == prefix or module.startswith(prefix + "."):
                remapped = "waldboost_tpu_torch" + module[len(prefix):]
                try:
                    return getattr(importlib.import_module(remapped), name)
                except (AttributeError, ImportError) as e:
                    raise pickle.UnpicklingError(
                        f"{module}.{name} has no counterpart in "
                        f"waldboost_tpu_torch") from e
        return super().find_class(module, name)


class StageRecord(NamedTuple):
    """One stage's statistics: survivor rates under the new theta (p0
    negatives, p1 positives) and the exp-loss after the stage."""

    p0: float
    p1: float
    loss: float


class Learner:
    """Boosting learner: appends one stage per ``fit_stage`` call.

    Stage statistics are one ``history`` list of :class:`StageRecord`; the
    ``p0``/``p1``/``losses`` views and the pickle checkpoint keep the
    three-list layout of the JAX package and the reference, so their
    checkpoints load here.
    """

    _CHECKPOINT_FIELDS = ("alpha", "wh", "wh_args")

    def __init__(self, alpha: float = 0.1, wh=DTree, **wh_args):
        self.alpha = alpha
        self.wh = wh
        self.wh_args = wh_args
        self.history: list[StageRecord] = []

    # -- stage history ----------------------------------------------------
    def record_stage(self, p0: float, p1: float, loss_: float) -> None:
        self.history.append(StageRecord(float(p0), float(p1), float(loss_)))

    @property
    def p0(self) -> list:
        return [s.p0 for s in self.history]

    @property
    def p1(self) -> list:
        return [s.p1 for s in self.history]

    @property
    def losses(self) -> list:
        return [s.loss for s in self.history]

    @property
    def false_positive_rate(self) -> float:
        out = 1.0
        for s in self.history:
            out *= s.p0
        return out

    @property
    def true_positive_rate(self) -> float:
        out = 1.0
        for s in self.history:
            out *= s.p1
        return out

    @property
    def loss(self):
        return self.history[-1].loss if self.history else None

    def __len__(self) -> int:
        return len(self.history)

    def __bool__(self) -> bool:
        return True

    def get_stats(self) -> dict:
        """Cumulative rate curves and the loss, one entry per stage."""
        rec = np.array(self.history, "f8").reshape(len(self.history), 3)
        return {
            "false_positive_rate": np.cumprod(rec[:, 0]),
            "true_positive_rate": np.cumprod(rec[:, 1]),
            "loss": rec[:, 2].copy(),
        }

    # -- checkpointing ----------------------------------------------------
    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in self._CHECKPOINT_FIELDS}
        d.update(p0=self.p0, p1=self.p1, losses=self.losses)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Learner":
        L = Learner(alpha=d["alpha"], wh=d["wh"], **d["wh_args"])
        stats = [d[k] for k in ("p0", "p1", "losses")]
        if len({len(s) for s in stats}) != 1:
            raise ValueError("Wrong values for p0, p1 or loss")
        L.history = [StageRecord(*t) for t in zip(*stats)]
        return L

    def save(self, filename: str) -> None:
        with open(filename, "wb") as f:
            pickle.dump(self.to_dict(), f)

    @staticmethod
    def load(filename: str) -> "Learner":
        """A learner checkpoint written by this package, the JAX package or
        the reference (their weak-learner classes map onto this
        package's)."""
        with open(filename, "rb") as f:
            return Learner.from_dict(_InteropUnpickler(f).load())

    def fit_stage(self, model, X0, H0, X1, H1, theta: Optional[float] = None,
                  **wh_args) -> Tuple[float, float, float]:
        """Fit one boosting stage on the model's device and append it to
        ``model``.  ``theta=None`` estimates the threshold by SPRT; any
        float (-inf too) is used as given."""
        W0 = weights(H0)
        W1 = weights(-np.asarray(H1))

        with span("wb.train.fit"):
            weak = self.wh.fit(X0, W0, X1, W1, device=model.device,
                               **{**self.wh_args, **wh_args})

        with span("wb.train.sprt"):
            H0 = np.asarray(H0) + weak.predict(X0)
            H1 = np.asarray(H1) + weak.predict(X1)
            if theta is None:
                theta = fit_rejection_threshold(
                    H0, self.false_positive_rate, H1,
                    self.true_positive_rate, self.alpha)

            self.record_stage((H0 >= theta).sum() / max(H0.size, 1),
                              (H1 >= theta).sum() / max(H1.size, 1),
                              loss(H0, H1))

        model.append(weak, theta)
        return self.loss, self.false_positive_rate, self.true_positive_rate


def fit_rejection_threshold(H0, P0, H1, P1, alpha) -> float:
    """Wald SPRT rejection threshold: over the unique responses t, the
    likelihood ratio ``R = (P0*p0 + (1-P0) + 1e-6) / (P1*p1 + (1-P1) +
    1e-6)`` with ``p = P(H < t)``; returns the largest t with ``R >
    1/alpha``."""
    H0 = np.asarray(H0, np.float64)
    H1 = np.asarray(H1, np.float64)
    if H0.size == 0 or H1.size == 0:
        logger.log(15, "Empty sample class, theta forced to -inf")
        return float(-np.inf)
    max0 = np.max(H0)
    min1 = np.min(H1)
    if max0 < min1:
        logger.log(15, f"H0 and H1 are non-overlapping H0 < {max0}, "
                       f"H1 > {min1}")
        return float(min1)
    ts = np.sort(np.unique(np.concatenate([H0.ravel(), H1.ravel()])))
    if ts.size < 3:
        logger.log(15, "Not enough unique responses to estimate theta")
        return float(-np.inf)
    ts = ts[1:]
    p0 = np.searchsorted(np.sort(H0.ravel()), ts, side="left") / H0.size
    p1 = np.searchsorted(np.sort(H1.ravel()), ts, side="left") / H1.size
    R = (P0 * p0 + (1 - P0) + 1e-6) / (P1 * p1 + (1 - P1) + 1e-6)
    A = 1 / alpha
    idx = np.nonzero(R > A)[0]
    if idx.size == 0:
        theta = -np.inf
    else:
        theta = ts[np.max(idx)]
    logger.log(15, f"theta = {theta:.4f}")
    return float(theta)


def fit_rejection_threshold_device(H0, H1, P0, P1, alpha, v0=None, v1=None
                                   ) -> torch.Tensor:
    """Fixed-shape float32 SPRT threshold with the semantics of
    :func:`fit_rejection_threshold`, as a 0-dim tensor on the scores'
    device.

    ``v0``/``v1`` mark the valid entries of padded score vectors (padding
    sorts to +inf, where it never counts as "< t" and is no candidate).
    Equal candidates give equal ratios, and "drop the smallest unique
    value" becomes "exclude every candidate equal to the minimum"; the
    special cases (non-overlapping classes, fewer than 3 unique responses,
    an empty class) are selects.
    """
    H0 = torch.as_tensor(H0, dtype=torch.float32).reshape(-1)
    H1 = torch.as_tensor(H1, dtype=torch.float32, device=H0.device)
    H1 = H1.reshape(-1)
    v0 = torch.ones_like(H0, dtype=torch.bool) if v0 is None \
        else torch.as_tensor(v0, device=H0.device).reshape(-1).bool()
    v1 = torch.ones_like(H1, dtype=torch.bool) if v1 is None \
        else torch.as_tensor(v1, device=H0.device).reshape(-1).bool()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=H0.device)
    n0 = torch.clamp(v0.sum(), min=1)
    n1 = torch.clamp(v1.sum(), min=1)
    h0 = torch.where(v0, H0, inf)
    h1 = torch.where(v1, H1, inf)
    ts = torch.sort(torch.cat([h0, h1])).values  # padding sorts last
    finite = torch.isfinite(ts)
    n_unique = 1 + ((torch.diff(ts) > 0) & finite[1:]).sum()
    p0 = torch.searchsorted(torch.sort(h0).values, ts, side="left") / n0
    p1 = torch.searchsorted(torch.sort(h1).values, ts, side="left") / n1
    R = (P0 * p0 + (1 - P0) + 1e-6) / (P1 * p1 + (1 - P1) + 1e-6)
    A = 1.0 / alpha
    cand = (R > A) & (ts != ts[0]) & finite
    theta_sprt = torch.where(cand, ts, -inf).max()
    max0 = torch.where(v0, H0, -inf).max()
    min1 = torch.where(v1, H1, inf).min()
    theta = torch.where(max0 < min1, min1,
                        torch.where(n_unique < 3, -inf, theta_sprt))
    empty = (v0.sum() == 0) | (v1.sum() == 0)
    return torch.where(empty, -inf, theta)


class BasicRejectionSchedule:
    """theta = -inf outside a stage interval or once the cumulative p0 is
    below ``target_p0``; otherwise None (estimate from data)."""

    def __init__(self, rejection_interval=(0, None), target_p0: float = 1e-5):
        if rejection_interval is None:
            rejection_interval = (None, None)
        self.s0 = rejection_interval[0] or 0
        self.s1 = rejection_interval[1] if rejection_interval[1] is not None \
            else np.inf
        self.target_p0 = target_p0

    def __call__(self, stage: int, p0: float):
        if stage < self.s0 or stage > self.s1 or p0 < self.target_p0:
            return float(-np.inf)
        return None
