"""Carry a cascade across from the JAX package as plain numpy.

The JAX model's ``[w.to_stage_dict() for w in model.classifier]`` and
``model.theta`` hold everything the port serves, so the same random or
trained cascade can be handed to both packages without a file.
"""

from __future__ import annotations

from typing import Dict, Sequence

from .model import Model

__all__ = ["model_from_stages"]


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
