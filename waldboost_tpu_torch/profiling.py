"""Observability: profiler traces and cascade efficiency counters.

Counterpart of ``waldboost_tpu/profiling.py``: annotations of pipeline
phases in the torch profiler's timeline, one profiler session over the
host and the card written as a Chrome trace, and a wall-clock throughput
meter for benchmarking loops that also folds in a model's cascade cost
counters (``Model.cost_stats``).

The serving path marks its steps with :func:`span`, which records only
while a torch profiler runs: ``wb.octaves``, ``wb.planes``,
``wb.channels``, ``wb.cascade``, ``wb.extract``, ``wb.nms`` (and the
two-phase and verifier steps), one ``wb.nms.round`` a round of the greedy
NMS loop (``ops/nms.py::nms_plain``, the CPU's NMS; the card's, kernel S3,
has no rounds on the host), and one ``wb.sync`` at each point where the
host waits for the card (a read of a device value, a blocking copy).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.profiler import record_function

__all__ = ["trace_annotation", "tracing", "span", "start_trace",
           "stop_trace", "Meter"]

_UNTRACED = contextlib.nullcontext()


def trace_annotation(name: str):
    """Context manager: a span named ``name`` in the profiler timeline.

    Usage::
        with trace_annotation("channels"):
            canvas = compute_canvas(image)
    """
    return torch.profiler.record_function(name)


def tracing() -> bool:
    """True while a torch profiler runs."""
    return torch._C._autograd._profiler_enabled()


def span(name: str, traced: Optional[bool] = None):
    """A profiler span named ``name`` while a torch profiler runs, else
    nothing: an ungated ``record_function`` costs about 10 us of host time
    per span.  ``traced`` is :func:`tracing` taken once by a caller that
    opens many spans (a loop), in place of a test per span."""
    if tracing() if traced is None else traced:
        return record_function(name)
    return _UNTRACED


class _Trace:
    """The running profiler session of :func:`start_trace`."""

    profiler: Optional[torch.profiler.profile] = None
    log_dir: Optional[str] = None


def start_trace(log_dir: str) -> None:
    """Start one profiler session over the CPU (and CUDA, when there is a
    card); :func:`stop_trace` writes its Chrome trace into ``log_dir``."""
    if _Trace.profiler is not None:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _Trace.profiler, _Trace.log_dir = prof, log_dir


def stop_trace() -> str:
    """Stop the session of :func:`start_trace` and write its trace as
    ``<log_dir>/trace_<pid>_<ns>.json`` (viewable in Perfetto or
    chrome://tracing); returns the file's path."""
    prof, log_dir = _Trace.profiler, _Trace.log_dir
    if prof is None:
        raise RuntimeError("no trace is running")
    _Trace.profiler = _Trace.log_dir = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def _synchronize(tree) -> None:
    """Wait for the CUDA devices of the tensors in ``tree`` (a tensor or
    nested lists, tuples and dict values of them)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass
class Meter:
    """Wall-clock throughput meter with named phases.

    Waits at the end of a phase for the CUDA devices of the tensors given
    as ``block_on``, so the numbers mean what they say.  Example::

        meter = Meter()
        with meter.phase("detect", items=batch, pixels=batch*h*w,
                         block_on=images):
            out = fn(images)
        print(meter.report())
    """

    totals: Dict[str, float] = field(default_factory=dict)
    items: Dict[str, float] = field(default_factory=dict)
    pixels: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    def note_model(self, model, name: str = "detector") -> None:
        """Fold a model's cascade-efficiency counters (running average,
        worst-case scan, survivor histogram: ``Model.cost_stats``) into
        the report."""
        stats = model.cost_stats()
        self.counters[f"{name}.eval_cost"] = stats["eval_cost"]
        self.counters[f"{name}.worst_eval_cost"] = stats["worst_eval_cost"]
        self.counters[f"{name}.n_images"] = stats["n_images"]
        surv = stats["stage_survivors"]
        if surv is not None and len(surv) and surv[0] > 0:
            # the depth at which survivors fall below 10% / 1% of the
            # scanned windows (the whole histogram: cost_stats)
            frac = surv / float(surv[0])
            for q, lbl in ((0.1, "depth_10pct"), (0.01, "depth_1pct")):
                below = (frac < q).nonzero()[0]
                self.counters[f"{name}.{lbl}"] = float(
                    below[0] if len(below) else len(surv))

    @contextlib.contextmanager
    def phase(self, name: str, items: float = 0, pixels: float = 0,
              block_on=None):
        """Time the block as phase ``name``; the CUDA devices of the
        tensors in ``block_on`` are synchronised before the clock
        stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.items[name] = self.items.get(name, 0.0) + items
            self.pixels[name] = self.pixels.get(name, 0.0) + pixels

    def report(self) -> str:
        lines = []
        for name, dt in sorted(self.totals.items()):
            parts = [f"{name}: {dt * 1e3:.2f} ms"]
            if self.items.get(name):
                parts.append(f"{self.items[name] / dt:.1f} items/s")
            if self.pixels.get(name):
                parts.append(f"{self.pixels[name] / dt / 1e6:.1f} MP/s")
            lines.append("  ".join(parts))
        for name, val in sorted(self.counters.items()):
            lines.append(f"{name}: {val:g}")
        return "\n".join(lines)
