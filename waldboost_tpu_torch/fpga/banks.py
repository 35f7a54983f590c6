"""Pixel memory banks for conflict-free parallel feature reads in hardware.

The port's own copy of ``waldboost_tpu/fpga/banks.py``: a window's pixels
go to ``bh * bw`` banks by position, ``bank(r, c) = (r % bh) * bw + (c %
bw)`` for every channel, and the scheduler gives each tree depth one bank
in round-robin order, so a hardware tree evaluator's parallel reads at one
depth never collide on a memory port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["PixelBanks", "BankScheduler"]


class PixelBanks:
    """Window pixel -> memory bank map over an (H, W) or (H, W, C) window."""

    def __init__(self, shape: Sequence[int], block_shape: Tuple[int, int]):
        if len(shape) not in (2, 3):
            raise ValueError("Shape must be (H,W) or (H,W,C)")
        H, W = int(shape[0]), int(shape[1])
        C = int(shape[2]) if len(shape) == 3 else 1
        bh, bw = int(block_shape[0]), int(block_shape[1])
        rows = np.arange(H) % bh
        cols = np.arange(W) % bw
        plane = rows[:, None] * bw + cols[None, :]
        self.pattern = np.broadcast_to(plane[:, :, None], (H, W, C)).copy()
        self.n_banks = bh * bw

    def bank_pixels(self, bank_ids) -> np.ndarray:
        """Flat (row-major HWC) pixel indices of ``bank_ids``, grouped by
        bank in the given order."""
        flat = self.pattern.reshape(-1)
        return np.concatenate([np.where(flat == b)[0] for b in bank_ids])


class BankScheduler:
    """One bank per tree depth, cycling through the banks across calls so
    consecutive stages use different memory ports."""

    def __init__(self, n_banks: int = 8):
        self.n_banks = int(n_banks)
        self._next = 0

    def schedule(self, max_depth: int = 2):
        out = []
        for _ in range(max_depth):
            out.append([self._next])
            self._next = (self._next + 1) % self.n_banks
        return out
