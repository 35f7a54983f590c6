"""waldboost_tpu_torch: the WaldBoost detector in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``waldboost_tpu`` (JAX/Pallas), held bitwise against it on
uint8 frames.  Module names mirror the JAX package's.  This package
imports torch and numpy only; the CUDA kernels under ``csrc/`` are built
with nvcc at their first use on a CUDA tensor, and a CPU tensor takes each
kernel's plain-torch version.  Entry points run on the card unless given
``device="cpu"``, and raise when there is no card.

Example::

    import waldboost_tpu_torch as wt
    from waldboost_tpu_torch.utils import fake_data_generator

    model = wt.load("models/flagship_synth_64.pb")      # on the card
    boxes = model.detect(image)                          # (H, W) uint8
    boxes = wt.detect(image, model, other_model, response_scale=[1, 0.5])

    model = wt.Model((12, 12, 4), dict(shrink=2, n_per_oct=4, smooth=1,
                                       channels="grad_hist"))
    learner = wt.train(model, fake_data_generator(seed=11), length=16,
                       pool=wt.SamplePool(min_tp=1000, min_fp=1000, seed=0),
                       learner=wt.Learner(alpha=0.2, max_depth=2))
"""

import itertools
import logging

import numpy as np

from . import boxes as bbx  # noqa: F401  (host box lists)
from . import fpga, groundtruth, testing, utils, verification  # noqa: F401
from .boxes import Boxes
from .channels import _normalize_opts, channel_pyramid, default_channel_opts
from .convert import model_from_stages
from .model import Model, detect_multi, load
from .parallel.detect import (detect_batch, make_batched_detector,
                              make_batched_detector_boxes,
                              make_multi_detector_boxes)
from .samples import SamplePool
from .training import BasicRejectionSchedule, DTree, Learner

__all__ = ["Boxes", "Model", "load", "load_model", "save", "save_model",
           "detect", "detect_multi", "detect_batch", "make_batched_detector",
           "make_batched_detector_boxes", "make_multi_detector_boxes",
           "model_from_stages", "train", "train_softcascade", "SamplePool",
           "Learner", "DTree", "BasicRejectionSchedule",
           "default_channel_opts"]

load_model = load


def save_model(model: Model, filename: str) -> None:
    """Save a model to a file the JAX package loads too."""
    model.save(filename)


save = save_model


def detect(image: np.ndarray, *models: Model, channel_opts: dict = None,
           response_scale=None, device=None) -> Boxes:
    """Detect with several models: boxes with 'scores' (scaled per model
    by ``response_scale``) and 'label' (the emitting model's index)
    fields, before NMS.  Models that share channel options scan one
    packed canvas (:func:`detect_multi`); otherwise every model scans each
    level of ``channel_opts``' pyramid (the first model's when None).
    Runs on ``device`` (the first model's when None)."""
    channel_opts = channel_opts or models[0].channel_opts
    if response_scale is None:
        response_scale = [1] * len(models)
    response_scale = np.array(response_scale, "f")
    if response_scale.size != len(models):
        raise ValueError("Wrong response_scale parameter")
    opts_key = _normalize_opts(channel_opts)
    if all(_normalize_opts(m.channel_opts) == opts_key for m in models):
        return detect_multi(models, image, response_scale=response_scale,
                            device=device)
    dev = models[0]._device_for(device)
    dt_boxes = []
    for chns, scale in channel_pyramid(image, channel_opts, device=dev):
        for k, model in enumerate(models):
            r, c, h = model.predict_on_image(chns)
            if r.size == 0:
                continue
            b = model.get_boxes(r, c, scale)
            b.set_field("scores", h * response_scale[k])
            b.set_field("label", np.full(r.size, k, dtype=np.int64))
            dt_boxes.append(b)
    return bbx.concatenate(dt_boxes, ["scores", "label"])


def train_softcascade(shape, channel_opts, length, training_images,
                      callbacks=(), casc_thr: float = -1.0,
                      pool: SamplePool = None, device=None):
    """Experimental constant-soft-cascade training: ``len(length)``
    sub-cascades of ``length[i]`` stages each with no per-stage rejection,
    then a constant rejection threshold.  Returns the final model (on
    ``device``, the card when None)."""
    logging.warning("train_softcascade is experimental; prefer wt.train")
    pool = pool or SamplePool(min_tp=4000, min_fp=20000, min_tp_iou=0.75,
                              max_tp_candidates=5, max_fp_candidates=50)
    model = Model(shape, channel_opts, device=device)
    pool.update(model, training_images)

    for stage, stage_length in enumerate(length):
        learner = _train_body(model, training_images, Learner(max_depth=2),
                              pool, stage_length, _no_rejection, (),
                              logging.getLogger("Training"))
        model.theta = [float(np.float32(casc_thr))] * len(model)
        model._version += 1
        for cb in callbacks:
            cb(model, learner, stage)
        if stage == len(length) - 1:
            return model
        pool.update(model, training_images)
        if pool.samples is not None and len(pool.samples):
            scores = pool.samples.get_field("scores")
            pool.samples.set_field("scores", np.zeros_like(scores))
        model = Model(shape, channel_opts, device=device)
    return model


def train(model: Model,
          training_images,
          learner: Learner = None,
          pool: SamplePool = None,
          length: int = 64,
          theta_schedule=None,
          callbacks=(),
          logger: logging.Logger = None,
          mesh=None,
          prefetch: int = 16):
    """Train or continue training ``model`` on its device.

    Per stage: refill and rescore the sample pool, fit one weak tree on
    exp-loss weights, fit the SPRT rejection threshold, run the callbacks.
    ``training_images`` is an iterable of dicts with ``"image"`` ((H, W)
    uint8) and ``"groundtruth_boxes"`` (:class:`Boxes`, optional 'ignore'
    field).  With ``mesh`` (:mod:`.parallel.mesh`) training runs the
    device-pool path sharded over its devices
    (:func:`.parallel.trainer.train_sharded`), its quotas, seed and
    labeling options taken from ``pool``.

    ``prefetch``: depth of the background-thread record prefetcher around
    ``training_images`` (0 disables it; sized iterables skip it).  Record
    order is kept and none is lost: on return the records pulled but not
    consumed are handed back to the next ``train`` call on the same
    iterable, so a resumed run sees the frames it would have seen.
    """
    logger = logger or logging.getLogger("Training")
    if mesh is not None:
        return _train_loop(training_images, prefetch, lambda images: (
            _train_mesh(model, images, learner, pool, length, theta_schedule,
                        callbacks, logger, mesh)))
    return _train_loop(training_images, prefetch, lambda images: (
        _train_body(model, images, learner, pool, length, theta_schedule,
                    callbacks, logger)))


def _no_rejection(stage, fpr) -> float:
    """train_softcascade's schedule: no per-stage rejection."""
    return float(-np.inf)


def _train_mesh(model, training_images, learner, pool, length,
                theta_schedule, callbacks, logger, mesh, **step_options):
    """``train``'s mesh path: :func:`.parallel.trainer.train_sharded` with
    ``pool``'s quotas, seed, mining batch and labeling options, the
    learner's tree depth and ``step_options`` (``fpga.train``'s)."""
    from .parallel.trainer import train_sharded
    pool_kwargs = {}
    if pool is not None:
        pool_kwargs = dict(min_tp=pool.min_tp, min_fp=pool.min_fp,
                           seed=pool.seed, mine_batch=pool.mine_batch,
                           **pool.label_boxes_args)
    learner = learner or Learner(alpha=0.2, max_depth=2)
    step_options.setdefault("max_depth",
                            int(learner.wh_args.get("max_depth", 2)))
    return train_sharded(model, training_images, mesh=mesh, learner=learner,
                         length=length, theta_schedule=theta_schedule,
                         callbacks=callbacks, logger=logger, **pool_kwargs,
                         **step_options)


def _train_loop(training_images, prefetch, body):
    """``body(records)`` behind ``train``'s record prefetcher, with the
    residue hand-back; shared by ``train`` and ``fpga.train``."""
    prefetcher = None
    source = training_images
    if prefetch and not hasattr(training_images, "__len__"):
        from .io import Prefetcher
        feed = training_images
        residue = _prefetch_residue.pop(id(source), (None, None))[1]
        if residue:
            feed = itertools.chain(residue, feed)
        prefetcher = Prefetcher(feed, depth=prefetch)
        training_images = iter(prefetcher)
    try:
        return body(training_images)
    finally:
        if prefetcher is not None:
            leftover = prefetcher.stop()
            if leftover:
                # keyed by id() with the source kept alive in the value, so
                # the key cannot be recycled
                _prefetch_residue[id(source)] = (source, leftover)


#: records pulled by train()'s prefetcher but not consumed, handed back to
#: the next train() call on the same iterable: {id(source): (source, [recs])}
_prefetch_residue: dict = {}


def _train_body(model, training_images, learner, pool, length,
                theta_schedule, callbacks, logger, stage_args=None):
    """The stage loop.  ``stage_args(stage)``, when given, returns extra
    keyword arguments of that stage's fit (``fpga.train``'s scheduled
    ``allowed_features``)."""
    if len(model) >= length:
        return learner

    learner = learner or Learner()
    if theta_schedule is None:
        theta_schedule = BasicRejectionSchedule()

    if len(model) != len(learner):
        raise RuntimeError("Model length and learner length are not "
                           "consistent")

    if len(model) > 0:
        logger.info(f"{len(model)} stages are already present, continuing")

    pool = pool or SamplePool()

    for stage in range(len(model), length):
        logger.info(f"Training stage {stage}")
        pool.update(model, training_images)
        X0, H0 = pool.get_false_positives()
        X1, H1 = pool.get_true_positives()
        extra = stage_args(stage) if stage_args is not None else {}
        stage_loss, p0, p1 = learner.fit_stage(
            model, X0, H0, X1, H1, **extra,
            theta=theta_schedule(stage, learner.false_positive_rate))
        logger.log(15, f"Stage {stage}: loss: {stage_loss:g}, fpr: {p0:g}, "
                       f"tpr: {p1:g}")
        for cb in callbacks:
            cb(model, learner, stage)
    return learner
