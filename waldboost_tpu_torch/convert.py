"""Carry a cascade or a CNN verifier across from the JAX package as plain
numpy.

The JAX model's ``[w.to_stage_dict() for w in model.classifier]`` and
``model.theta`` hold everything the port serves, so the same random or
trained cascade can be handed to both packages without a file; the flax
verifier's parameter tree, as nested dicts of numpy arrays, becomes the
state dict of :class:`~waldboost_tpu_torch.verification.VerifierCNN`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .model import Model

__all__ = ["model_from_stages", "verifier_state_dict"]


def model_from_stages(shape, channel_opts: Dict, stages: Sequence[Dict],
                      theta: Sequence[float], device=None) -> Model:
    """Build the port's :class:`Model` from stage dicts and thresholds, to
    run on ``device`` (the card when None).  ``channel_opts["channels"]``
    may be a registry name or any object with a ``name`` attribute naming
    a registered channel function."""
    if len(stages) != len(theta):
        raise ValueError(f"{len(stages)} stages but {len(theta)} thetas")
    model = Model(shape, channel_opts, device=device)
    for stage, th in zip(stages, theta):
        model.append(stage, th)
    return model


def verifier_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """The :class:`~waldboost_tpu_torch.verification.VerifierCNN` state
    dict of the JAX package's flax verifier parameters (``{"params":
    {...}}`` or the inner dict; numpy or array-like leaves).  flax's
    convolution kernels are (kh, kw, in, out), torch's (out, in, kh, kw);
    its dense kernels are (in, out), torch's (out, in).  The first dense
    layer's rows follow flax's NHWC flattening, which the port's module
    keeps (it flattens after a permute to NHWC), so no row is moved."""
    p = params.get("params", params)
    arr = lambda a: torch.from_numpy(np.array(a, np.float32))
    out = {}
    for i in range(4):
        conv, norm = p[f"Conv_{i}"], p[f"GroupNorm_{i}"]
        out[f"convs.{i}.weight"] = arr(np.transpose(conv["kernel"],
                                                    (3, 2, 0, 1)))
        out[f"convs.{i}.bias"] = arr(conv["bias"])
        out[f"norms.{i}.weight"] = arr(norm["scale"])
        out[f"norms.{i}.bias"] = arr(norm["bias"])
    for i in range(2):
        dense = p[f"Dense_{i}"]
        out[f"dense{i}.weight"] = arr(np.asarray(dense["kernel"]).T)
        out[f"dense{i}.bias"] = arr(dense["bias"])
    return out
