"""The least time the chip could take for a cell's work.

Counts are worked out from the cell's shapes and from the reference's
own walk of the same frames, never from the program's kernels, so they
read the same whatever implements the work.  Each count is one that no
implementation can go under: a value the work needs is counted once, the
arithmetic at one operation per value it must produce.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): 3.35 TB/s of HBM3, 67 TFLOP/s float32 outside the tensor
cores.  A card set below 700 W reaches less; the run prints its limit.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_S", "F32_OPS_S", "least_s", "mean_least_s",
           "cascade_work", "step_work"]

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def least_s(n_bytes: float, ops: float, chips: int = 1) -> float:
    """Seconds of the larger of the two bounds on ``chips`` chips."""
    return max(n_bytes / HBM_BYTES_S, ops / F32_OPS_S) / chips


def mean_least_s(work, runs, cfg: dict, chips: int = 1) -> float:
    """Mean over the window's calls of the least seconds of ``work``
    (``cascade_work`` or ``step_work``) of each call's reference
    statistics ``runs``."""
    return sum(least_s(*work(s, cfg), chips) for s in runs) / len(runs)


def cascade_work(stats: dict, cfg: dict):
    """``(bytes, ops)`` of the cascade over one call's frames.

    Bytes: each canvas value that some window's evaluated node read, once,
    at the configuration's ``canvas_value_bytes`` (the fewest bytes that
    hold a value exactly: 4 for float32 channels, 1 for the FPGA family's
    integers); the thresholds, leaf values and thetas of the stages some
    window entered, 4 bytes each; and the survivors' scores and origins
    (4 bytes each) with the per-frame survivor count and ``n_weak``.
    Ops: one comparison a node evaluated, one add and one comparison a
    stage entered."""
    n_bytes = (stats["canvas_values_read"] * cfg["canvas_value_bytes"]
               + 4 * stats["model_values"] + 8 * stats["survivors"]
               + 8 * stats["frames"])
    ops = stats["node_evals"] + 2 * stats["n_weak"]
    return n_bytes, ops


def step_work(stats: dict, cfg: dict):
    """``(bytes, ops)`` of a whole call: the frames read once (1 byte a
    pixel), the model's values once, the outputs written once (``k``
    boxes of 4 float32, scores, keep flags, the count and ``n_weak`` a
    frame).  Ops: every pixel of every level's image made once (the
    resize) and its channels made once (one operation a channel value),
    each pooled channel value once, and the cascade's operations."""
    frames = stats["frames"]
    h, w = cfg["frame_hw"]
    k = stats["k_slots"]
    n_bytes = (frames * h * w + 4 * stats["model_values"]
               + frames * (k * (16 + 4 + 1) + 8))
    ops = frames * (stats["level_pixels"] * (1 + stats["channels"])
                    + stats["canvas_values"]) \
        + cascade_work(stats, cfg)[1]
    return n_bytes, ops
