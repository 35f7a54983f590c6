"""Window crops and their cascade scores, gathered on the device.

Counterpart of the gathers of ``waldboost_tpu/mining.py``
(``_gather_windows_batch_jit``, ``_gather_windows_scores_batch_jit``):
plain torch indexing, exact copies.  The JAX module's background compile
prewarming and bit-packed survivor transfer serve the TPU's compiler and
its slow device link, and have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["gather_windows", "gather_windows_scores"]


def gather_windows(canvas: torch.Tensor, bs: torch.Tensor, rs: torch.Tensor,
                   cs: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """(K, m, n, C) HWC crops of a (B, C, H, W) canvas at the windows whose
    image, row and column are ``bs``, ``rs`` and ``cs`` (K,)."""
    m, n = window
    dev = canvas.device
    C = canvas.shape[1]
    bs, rs, cs = (t.to(dev, torch.int64) for t in (bs, rs, cs))
    rows = rs[:, None, None, None] + torch.arange(m, device=dev)[:, None,
                                                                  None]
    cols = cs[:, None, None, None] + torch.arange(n, device=dev)[:, None]
    return canvas[bs[:, None, None, None], torch.arange(C, device=dev),
                  rows, cols]


def gather_windows_scores(canvas: torch.Tensor, hs: torch.Tensor,
                          bs: torch.Tensor, rs: torch.Tensor,
                          cs: torch.Tensor, window: Tuple[int, int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gather_windows` and the (K,) scores ``hs[bs, rs, cs]`` of a
    (B, GU, GV) score map."""
    crops = gather_windows(canvas, bs, rs, cs, window)
    idx = [t.to(hs.device, torch.int64) for t in (bs, rs, cs)]
    return crops, hs[idx[0], idx[1], idx[2]]
