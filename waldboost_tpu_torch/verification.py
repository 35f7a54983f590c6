"""CNN verification of cascade detections.

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
into the bucket program.

Training: :func:`init_verifier` draws flax's initialisers (LeCun normal
kernels, zero biases), :func:`train` is the JAX package's balanced-batch
loop (the same numpy draws of the windows, the clamped exponential loss
:func:`exploss`, optax's Adam written out in optax's order) at full
float32 with deterministic cuDNN algorithms; dropout masks come from a
seeded torch generator (flax's ``jax.random`` masks cannot be
reproduced).
"""

from __future__ import annotations

import contextlib
import copy
import math
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .boxes import Boxes
from .device import resolve_device
from .ops.fit import full_f32_matmul

__all__ = ["VerifierCNN", "init_verifier", "exploss", "train",
           "VerifierProgram", "get_verifier_program", "verify_scores",
           "detect_and_verify"]


#: the rate of flax's two dropout layers
DROPOUT = 0.2


class VerifierCNN(nn.Module):
    """The JAX package's verifier topology for (m, n, C) windows: two 3x3
    convolutions of 8 channels, a 2x2 max pool (odd sizes floored), two
    of 16, each convolution followed by GroupNorm(4) (flax's epsilon,
    1e-6) and ReLU; then the features flattened in (h, w, c) order, as
    flax flattens NHWC, a dense layer of 128 with ReLU and one of 1.
    Dropout of rate :data:`DROPOUT` sits where flax's two ``Dropout(0.2)``
    layers sit: after the flatten and after the 128-wide layer's ReLU.
    torch's GroupNorm computes the variance
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

    def _drop(self, x: torch.Tensor, generator) -> torch.Tensor:
        """flax's Dropout: each element kept with probability ``1 -
        DROPOUT`` and divided by it, the mask drawn from ``generator``;
        the identity when no generator is given (flax's deterministic
        default)."""
        if generator is None:
            return x
        keep_prob = 1.0 - DROPOUT
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """(K,) outputs of (K, m, n, C) windows; dropout runs only with
        a ``generator`` for its masks (training)."""
        x = x.permute(0, 3, 1, 2)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            if i == 2:
                x = nn.functional.max_pool2d(x, 2, 2)
            x = torch.relu(norm(conv(x)))
        x = self._drop(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1),
                       generator)
        x = self._drop(torch.relu(self.dense0(x)), generator)
        return self.dense1(x)[:, 0]


#: flax's LeCun normal: a normal truncated to (-2, 2) in units of its own
#: standard deviation, scaled so that the truncated draw has variance
#: 1 / fan_in (the constant is that truncated normal's standard deviation)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal()`` draw of ``shape`` (float32, CPU), by the
    inverse CDF as ``jax.random.truncated_normal`` draws it."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    z = z.clamp(-2.0, 2.0)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).float()


def init_verifier(input_shape: Tuple[int, int, int], seed: int = 0):
    """``(module, params)`` for windows of ``input_shape`` (m, n, C):
    a :class:`VerifierCNN` and its state dict (CPU tensors) drawn with
    flax's initialisers from ``torch.Generator`` seeded ``seed``: LeCun
    normal kernels (fan-in the kernel's inputs), zero biases, GroupNorm
    scales one and biases zero.  The draws are flax's distributions, not
    its values."""
    module = VerifierCNN(input_shape)
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    for name, t in module.state_dict().items():
        if name.endswith("bias"):
            params[name] = torch.zeros_like(t)
        elif name.startswith("norms."):
            params[name] = torch.ones_like(t)
        else:
            fan_in = int(np.prod(t.shape[1:]))
            params[name] = _lecun_normal(tuple(t.shape), fan_in, gen)
    return module, params


def exploss(y: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """The clamped exponential loss ``exp(-y * y_pred)`` in [1e-6, 1e3]."""
    return torch.clamp(torch.exp(-y * y_pred), 1e-6, 1e3)


#: optax.adam's hyperparameters (eps_root 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block (its default
    backward algorithms may sum with atomics), the caller's settings
    restored after."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def _adam_step(params, grads, mu, nu, t: int, lr: float) -> None:
    """One optax Adam update of ``params`` in place, in optax's order:
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g*g + b2 nu``, the bias
    corrections ``1 - b**t`` in float32, ``p + (-lr) * (mu_hat /
    (sqrt(nu_hat) + eps))``."""
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(t))
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
        v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v)
        update = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        p.copy_(p + (-lr) * update)


def train(module: VerifierCNN, params: Dict, X0, H0, X1, H1,
          epochs: int = 10, batch_size: int = 64, steps: int = 1000,
          lr: float = 1e-4, seed: int = 0, verbose: bool = True,
          device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's balanced-batch training loop on ``device`` (the
    card when None); returns the trained state dict (CPU tensors).

    ``module`` is trained as given (a copy of it, with ``params``
    loaded), its ``forward`` called with the dropout masks' generator: a
    subclass whose ``forward`` ignores the generator trains with dropout
    off.  Each step draws
    ``b = batch_size // 2`` windows of each class as JAX does
    (``RandomState(seed).choice`` over X0, then over X1), labels ``[-1]
    * b + [1] * b``, indexes the pools staged on the device once, and
    minimises the mean of :func:`exploss` of ``cnn(X) + H`` by optax's
    Adam (``lr``, b1 0.9, b2 0.999, eps 1e-8); dropout masks come from a
    torch generator seeded ``seed + 1``.  Every pass runs at full float32
    (no TF32) with deterministic cuDNN algorithms, so two runs on one
    device give equal parameters.  With ``verbose``, prints JAX's
    ``Epoch e/E: loss x`` line (the mean of the epoch's step losses)."""
    dev = resolve_device(device)
    stage = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).to(dev)
    X0, X1 = stage(X0), stage(X1)
    H0, H1 = stage(np.ravel(H0)), stage(np.ravel(H1))
    b = batch_size // 2
    y = torch.tensor([-1.0] * b + [1.0] * b, dtype=torch.float32,
                     device=dev)
    net = copy.deepcopy(module).to(dev)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v))
                         for k, v in params.items()})
    net.train()
    leaves = list(net.parameters())
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
    t = 0
    with full_f32_matmul(), _deterministic_cudnn():
        for e in range(1, epochs + 1):
            losses = []
            for _ in range(steps):
                i0 = torch.from_numpy(rng.choice(X0.shape[0], b)).to(dev)
                i1 = torch.from_numpy(rng.choice(X1.shape[0], b)).to(dev)
                xb = torch.cat([X0[i0], X1[i1]])
                hb = torch.cat([H0[i0], H1[i1]])
                loss = torch.mean(exploss(y, net(xb, gen) + hb))
                grads = torch.autograd.grad(loss, leaves)
                t += 1
                with torch.no_grad():
                    _adam_step(leaves, grads, mu, nu, t, lr)
                losses.append(loss.detach())
            if verbose:
                step_losses = torch.stack(losses).cpu().numpy()
                print(f"Epoch {e}/{epochs}: loss "
                      f"{np.mean(step_losses.astype(np.float64)):.6f}")
    return {k: v.detach().cpu().clone()
            for k, v in net.state_dict().items()}


class VerifierProgram:
    """``prog(X, H) -> cnn(X) + H`` on one device: the module with
    ``params`` (a state dict) loaded, in eval mode, every float32 product
    and convolution at full precision.  A batch of any size runs as is:
    GroupNorm normalises each window on its own, so the batch's other
    windows (or padding, which the JAX package adds to bound its
    compiles) change a score by rounding at most (the convolution's
    algorithm may depend on the batch size).

    With ``mesh`` (:mod:`~waldboost_tpu_torch.parallel.mesh`) a copy of
    the network sits on each of this process's mesh devices, the windows
    are split over them (their count a multiple of the mesh size) and
    the scores gathered back on the first one, :attr:`device`."""

    def __init__(self, module: VerifierCNN, params: Dict, device,
                 mesh=None):
        self.mesh = mesh
        devices = [resolve_device(device)] if mesh is None \
            else list(mesh.local_devices)
        self.device = devices[0]
        self.nets = {}
        for d in devices:
            if d not in self.nets:
                net = VerifierCNN(module.input_shape).to(d)
                net.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                     for k, v in params.items()})
                self.nets[d] = net.eval()
        self.net = self.nets[self.device]

    def __call__(self, X: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """(K, m, n, C) windows and (K,) cascade scores -> (K,) float32
        verified scores on :attr:`device`."""
        with torch.no_grad(), full_f32_matmul():
            if self.mesh is None:
                return self._run(self.device, X, H)
            # imported here: the parallel package imports this module
            from .parallel.mesh import gather, shard_array
            return gather([self._run(x.device, x, h) for x, h in zip(
                shard_array(X, self.mesh, self.mesh.axis_name),
                shard_array(H, self.mesh, self.mesh.axis_name))],
                self.mesh)

    def _run(self, device, X, H):
        return self.nets[device](X.to(device, torch.float32)) \
            + H.to(device, torch.float32)


_PROGRAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_verifier_program(module: VerifierCNN, params: Dict,
                         device=None, mesh=None) -> VerifierProgram:
    """The memoized :class:`VerifierProgram` of (module, params, device,
    mesh) identity (entries hold ``params``, so an ``id`` is never reused
    while its entry lives); ``device`` is the card when None, and a mesh
    takes its place."""
    dev = resolve_device(device) if mesh is None else None
    progs = _PROGRAMS.setdefault(module, [])
    for p, d, m, prog in progs:
        if p is params and d == dev and m == mesh:
            return prog
    prog = VerifierProgram(module, params, dev, mesh)
    progs.append((params, dev, mesh, prog))
    return prog


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` with zero rows appended up to a multiple of ``multiple``."""
    pad = -x.shape[0] % multiple
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) \
        if pad else x


def verify_scores(module: VerifierCNN, params: Dict, X, H,
                  device=None, mesh=None, batch_size: int = 256
                  ) -> np.ndarray:
    """``cnn(X) + H`` of (K, m, n, C) windows and (K,) scores (numpy) on
    ``device`` (the card when None), as a (K,) float32 numpy array; with
    ``mesh`` over its devices, the windows padded to a multiple of its
    size (as the JAX package pads them).  ``batch_size`` is accepted for
    JAX's signature and, as there, not read: the windows go in one call."""
    X = np.asarray(X, np.float32)
    H = np.asarray(H, np.float32).ravel()
    k = X.shape[0]
    if k == 0:
        return np.zeros(0, np.float32)
    prog = get_verifier_program(module, params, device, mesh)
    mult = 1 if mesh is None else mesh.size
    return prog(_pad_rows(torch.from_numpy(X), mult),
                _pad_rows(torch.from_numpy(H), mult))[:k].cpu().numpy()


def detect_and_verify(image, model, module: VerifierCNN, params: Dict,
                      mesh=None) -> Boxes:
    """The model's surviving windows of ``image`` re-scored by the
    verifier on the model's device (with ``mesh``, over its devices):
    Boxes with ``scores`` (verified) and ``cascade_scores``, rows in
    canvas order.  The windows are cropped from the scan's canvas on the
    device; only the scores come back."""
    scan = model.scan_packed(image)
    if scan is None or scan[2].size == 0:
        return Boxes(np.empty((0, 4), np.float32),
                     scores=np.empty(0, np.float32))
    canvas, packed, rs, cs, hs = scan
    crops, _ = model.gather_windows_device(canvas, rs, cs, is_canvas=True,
                                           as_device=True)
    prog = get_verifier_program(module, params, canvas.device, mesh)
    mult = 1 if mesh is None else mesh.size
    verified = prog(_pad_rows(crops, mult), _pad_rows(
        torch.from_numpy(np.asarray(hs, np.float32)), mult))[:len(hs)]
    level_id, inv_scales = packed.level_maps(model.shape[:2])
    out = model._boxes_from_canvas_origins(rs, cs, verified.cpu().numpy(),
                                           packed, level_id, inv_scales)
    out.set_field("cascade_scores", np.asarray(hs, np.float32))
    return out
