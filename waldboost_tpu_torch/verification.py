"""CNN verification of cascade detections: the serving half.

Counterpart of ``waldboost_tpu/verification.py``: a small CNN re-scores
the detector's surviving windows as ``cnn(X) + H`` (X the window's (m, n,
C) channels, H its cascade score).  :class:`VerifierCNN` is the JAX
package's flax module in ``torch.nn`` layers (cuDNN convolutions, cuBLAS
dense layers, as JAX computes them in XLA), its parameters carried across
by :func:`~waldboost_tpu_torch.convert.verifier_state_dict`;
:class:`VerifierProgram` runs it on a device with every float32 product
and convolution at full precision (no TF32).  ``detect_and_verify``
rescans the packed pyramid (kernel B6) and crops the survivors on the
device; ``make_bucket_detector_boxes(verifier=...)`` fuses the rescoring
into the bucket program.  Training the verifier (the JAX package's
``train``, ``init_verifier``, optax) is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .boxes import Boxes
from .device import resolve_device
from .ops.fit import full_f32_matmul

__all__ = ["VerifierCNN", "VerifierProgram", "get_verifier_program",
           "verify_scores", "detect_and_verify"]


class VerifierCNN(nn.Module):
    """The JAX package's verifier topology for (m, n, C) windows: two 3x3
    convolutions of 8 channels, a 2x2 max pool (odd sizes floored), two
    of 16, each convolution followed by GroupNorm(4) (flax's epsilon,
    1e-6) and ReLU; then the features flattened in (h, w, c) order, as
    flax flattens NHWC, a dense layer of 128 with ReLU and one of 1.
    Dropout is off in serving.  torch's GroupNorm computes the variance
    in two passes where flax takes ``E[x*x] - E[x]**2``; on the tests'
    inputs both stay as close to a float64 evaluation as flax does.
    ``forward`` takes (K, m, n, C) windows and returns (K,)."""

    def __init__(self, input_shape: Tuple[int, int, int]):
        super().__init__()
        m, n, C = (int(v) for v in input_shape)
        self.input_shape = (m, n, C)
        conv = lambda i, o: nn.Conv2d(i, o, 3, padding=1)
        self.convs = nn.ModuleList([conv(C, 8), conv(8, 8), conv(8, 16),
                                    conv(16, 16)])
        self.norms = nn.ModuleList([nn.GroupNorm(4, c, eps=1e-6)
                                    for c in (8, 8, 16, 16)])
        self.dense0 = nn.Linear(16 * (m // 2) * (n // 2), 128)
        self.dense1 = nn.Linear(128, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            if i == 2:
                x = nn.functional.max_pool2d(x, 2, 2)
            x = torch.relu(norm(conv(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense1(torch.relu(self.dense0(x)))[:, 0]


class VerifierProgram:
    """``prog(X, H) -> cnn(X) + H`` on one device: the module with
    ``params`` (a state dict) loaded, in eval mode, every float32 product
    and convolution at full precision.  A batch of any size runs as is:
    GroupNorm normalises each window on its own, so the batch's other
    windows (or padding, which the JAX package adds to bound its
    compiles) change a score by rounding at most (the convolution's
    algorithm may depend on the batch size)."""

    def __init__(self, module: VerifierCNN, params: Dict, device):
        self.device = resolve_device(device)
        self.net = VerifierCNN(module.input_shape).to(self.device)
        self.net.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                  for k, v in params.items()})
        self.net.eval()

    def __call__(self, X: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """(K, m, n, C) windows and (K,) cascade scores on the device ->
        (K,) float32 verified scores."""
        with torch.no_grad(), full_f32_matmul():
            return self.net(X.to(self.device, torch.float32)) \
                + H.to(self.device, torch.float32)


_PROGRAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_verifier_program(module: VerifierCNN, params: Dict,
                         device=None) -> VerifierProgram:
    """The memoized :class:`VerifierProgram` of (module, params, device)
    identity (entries hold ``params``, so an ``id`` is never reused while
    its entry lives); ``device`` is the card when None."""
    dev = resolve_device(device)
    progs = _PROGRAMS.setdefault(module, [])
    for p, d, prog in progs:
        if p is params and d == dev:
            return prog
    prog = VerifierProgram(module, params, dev)
    progs.append((params, dev, prog))
    return prog


def verify_scores(module: VerifierCNN, params: Dict, X, H,
                  device=None) -> np.ndarray:
    """``cnn(X) + H`` of (K, m, n, C) windows and (K,) scores (numpy) on
    ``device`` (the card when None), as a (K,) float32 numpy array."""
    X = np.asarray(X, np.float32)
    H = np.asarray(H, np.float32).ravel()
    if X.shape[0] == 0:
        return np.zeros(0, np.float32)
    prog = get_verifier_program(module, params, device)
    return prog(torch.from_numpy(X), torch.from_numpy(H)).cpu().numpy()


def detect_and_verify(image, model, module: VerifierCNN, params: Dict
                      ) -> Boxes:
    """The model's surviving windows of ``image`` re-scored by the
    verifier on the model's device: Boxes with ``scores`` (verified) and
    ``cascade_scores``, rows in canvas order.  The windows are cropped
    from the scan's canvas on the device; only the scores come back."""
    scan = model.scan_packed(image)
    if scan is None or scan[2].size == 0:
        return Boxes(np.empty((0, 4), np.float32),
                     scores=np.empty(0, np.float32))
    canvas, packed, rs, cs, hs = scan
    crops, _ = model.gather_windows_device(canvas, rs, cs, is_canvas=True,
                                           as_device=True)
    prog = get_verifier_program(module, params, canvas.device)
    verified = prog(crops, torch.from_numpy(np.asarray(hs, np.float32)))
    level_id, inv_scales = packed.level_maps(model.shape[:2])
    out = model._boxes_from_canvas_origins(rs, cs, verified.cpu().numpy(),
                                           packed, level_id, inv_scales)
    out.set_field("cascade_scores", np.asarray(hs, np.float32))
    return out
