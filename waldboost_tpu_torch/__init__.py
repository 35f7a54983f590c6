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

    model = wt.load("models/flagship_synth_64.pb")      # on the card
    boxes = model.detect(image)                          # (H, W) uint8
    boxes = wt.detect(image, model, other_model, response_scale=[1, 0.5])
"""

import numpy as np

from . import boxes as bbx  # noqa: F401  (host box lists)
from .boxes import Boxes
from .channels import _normalize_opts
from .convert import model_from_stages
from .model import Model, detect_multi, load
from .parallel.detect import (detect_batch, make_batched_detector,
                              make_batched_detector_boxes,
                              make_multi_detector_boxes)

__all__ = ["Boxes", "Model", "load", "load_model", "save", "save_model",
           "detect", "detect_multi", "detect_batch", "make_batched_detector",
           "make_batched_detector_boxes", "make_multi_detector_boxes",
           "model_from_stages"]

load_model = load


def save_model(model: Model, filename: str) -> None:
    """Save a model to a file the JAX package loads too."""
    model.save(filename)


save = save_model


def detect(image: np.ndarray, *models: Model, channel_opts: dict = None,
           response_scale=None, device=None) -> Boxes:
    """Detect with several models over one shared channel pyramid: boxes
    with 'scores' (scaled per model by ``response_scale``) and 'label'
    (the emitting model's index) fields, before NMS.  Runs on ``device``
    (the first model's when None)."""
    channel_opts = channel_opts or models[0].channel_opts
    if response_scale is None:
        response_scale = [1] * len(models)
    response_scale = np.array(response_scale, "f")
    if response_scale.size != len(models):
        raise ValueError("Wrong response_scale parameter")
    opts_key = _normalize_opts(channel_opts)
    if not all(_normalize_opts(m.channel_opts) == opts_key for m in models):
        raise NotImplementedError(
            "models with different channel options need the per-level "
            "channel pyramid (channels.channel_pyramid), which is not ported "
            "yet (ROADMAP item A9)")
    return detect_multi(models, image, response_scale=response_scale,
                        device=device)
