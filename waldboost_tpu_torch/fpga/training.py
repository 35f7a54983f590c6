"""FPGA-constrained training: bank-restricted features, quantized responses.

Counterpart of ``waldboost_tpu/fpga/training.py`` (the host-pool path):
the training loop of :func:`waldboost_tpu_torch.train` with each tree
depth's features restricted to one scheduled memory bank (conflict-free
parallel pixel reads in hardware), integer thresholds, and clipped and
quantized leaf responses, so the detector evaluates in integer
arithmetic.  The split finder is the histogram fit of
:class:`waldboost_tpu_torch.training.DTree`.
"""

from __future__ import annotations

import logging

import numpy as np

from ..samples import SamplePool
from ..training import DTree as BaseDTree, Learner

from .banks import BankScheduler, PixelBanks

__all__ = ["DTree", "train"]

#: this module's logger, as in the JAX package (``train`` logs to
#: ``logger_`` or ``"WaldBoost/FPGA"``)
logger = logging.getLogger(__name__)


class DTree:
    """FPGA weak-learner fit: depth-restricted features, integer thresholds,
    clipped and quantized leaves.  Returns a plain
    :class:`waldboost_tpu_torch.training.DTree`."""

    @staticmethod
    def fit(X0, W0, X1, W1, max_depth: int = 2, min_samples_leaf: int = 10,
            allowed_features=None, clip: float = 3, quantizer: int = 32,
            n_bins: int = 256, device=None) -> BaseDTree:
        return BaseDTree.fit(
            X0, W0, X1, W1, max_depth=max_depth,
            min_samples_leaf=min_samples_leaf,
            allowed_features=allowed_features, backend="hist", n_bins=n_bins,
            clip=clip, quantizer=quantizer, integer_thresholds=True,
            device=device)


def train(model,
          training_images,
          learner: Learner = None,
          pool: SamplePool = None,
          length: int = 64,
          max_depth: int = 2,
          theta_schedule=None,
          bank_pattern_shape=(2, 2),
          clip: float = 3,
          quantizer: int = 32,
          callbacks=(),
          logger_: logging.Logger = None,
          mesh=None,
          prefetch: int = 16):
    """Train ``model`` (on its device) with FPGA-friendly feature access:
    the stage loop of :func:`waldboost_tpu_torch.train` (its prefetcher
    and record hand-back too) with each stage's fit restricted to the
    scheduled banks.

    ``bank_pattern_shape``: window pixels are tiled into this many banks;
    each stage's tree reads one scheduled bank per depth.  ``quantizer``:
    responses become integers when multiplied by it.

    With ``mesh``, training runs the sharded device-pool path
    (:func:`waldboost_tpu_torch.parallel.trainer.train_sharded`) with the
    bank restriction as per-stage feature masks and the clip, quantize
    and integer-threshold transforms applied in-step.
    """
    from .. import _train_body, _train_loop, _train_mesh

    log = logger_ or logging.getLogger("WaldBoost/FPGA")

    if len(model) >= length:
        return learner

    if mesh is not None:
        F = int(np.prod(model.shape))
        masks_fn = None
        if bank_pattern_shape is not None:
            banks = PixelBanks(model.shape, bank_pattern_shape)
            scheduler = BankScheduler(int(np.prod(bank_pattern_shape)))

            def masks_fn(stage):
                mask = np.zeros((max_depth, F), bool)
                for d, b in enumerate(scheduler.schedule(max_depth)):
                    mask[d, banks.bank_pixels(b)] = True
                return mask

        learner = learner or Learner(alpha=0.2, wh=DTree, clip=clip,
                                     quantizer=quantizer, max_depth=max_depth)
        return _train_loop(training_images, prefetch, lambda images: (
            _train_mesh(model, images, learner, pool, length, theta_schedule,
                        callbacks, log, mesh, max_depth=max_depth,
                        feature_masks_fn=masks_fn, clip=clip,
                        quantizer=quantizer, integer_thresholds=True)))

    learner = learner or Learner(wh=DTree, clip=clip, quantizer=quantizer)
    if learner.wh is not DTree:
        log.warning("Correcting learner.wh to fpga.DTree")
        learner.wh = DTree
    learner.wh_args["max_depth"] = max_depth

    stage_args = None
    if bank_pattern_shape is not None:
        banks = PixelBanks(model.shape, bank_pattern_shape)
        scheduler = BankScheduler(int(banks.n_banks))

        def stage_args(stage):
            return dict(allowed_features=[
                banks.bank_pixels(b) for b in scheduler.schedule(max_depth)])

    return _train_loop(training_images, prefetch, lambda images: (
        _train_body(model, images, learner, pool, length, theta_schedule,
                    callbacks, log, stage_args)))
