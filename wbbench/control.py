"""The comparison's control: the plain reference computed in the next
precision below the configuration's, put in the program's place.

The configuration's ``control`` names the precision: ``bf16`` rounds the
float32 canvas to bfloat16, ``int4`` cuts the FPGA family's 8-bit
channels to their top 4 bits.  :func:`wrap` gives ``run_cell``'s ``wrap``
hook, so a run of the control is an ordinary run of the cell whose window
drives the control in place of the detector, and the harness's own
comparison has to call it not correct.  ``wbbench/tests/
test_wbbench_harness.py`` runs it, on the CPU at a small size and on the
card at each cell's own size.  A run of the benchmark never runs it.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from .harness import ROOT, load_cell
from .reference.detector import OUTPUTS, ReferenceDetector

__all__ = ["wrap"]


def wrap(name: str, device, bench: Optional[dict] = None,
         root: str = ROOT) -> Callable:
    """The ``wrap`` hook of ``run_cell`` for cell ``name`` whose callable
    returns the control's five outputs in the detector's shapes and on
    its devices (a list of shards a output over a mesh); the control's
    reference runs on ``device``."""
    cfg = load_cell(name, bench, root)["config"]
    per = int(cfg["frames_per_chip"])
    ctl = ReferenceDetector(os.path.join(root, cfg["model"]),
                            tuple(cfg["frame_hw"]), int(cfg["k"]),
                            cfg["nms_iou"], device, control=cfg["control"])

    def outputs(x):
        got, _ = ctl(x.to(ctl.device))
        return [torch.from_numpy(got[key]).to(x.device) for key in OUTPUTS]

    def hook(det):
        def fn(x):
            if isinstance(x, (list, tuple)):
                return tuple(list(o) for o in zip(*map(outputs, x)))
            blocks = [outputs(x[i:i + per])
                      for i in range(0, x.shape[0], per)]
            return tuple(torch.cat(o) for o in zip(*blocks))
        return fn
    return hook
