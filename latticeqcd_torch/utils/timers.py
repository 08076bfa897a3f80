"""Per-phase timers and an optional torch.profiler region.

Counterpart of latticeqcd_tpu/utils/timers.py. ``PhaseTimers`` accumulates
named phase durations and reports them in the JAX package's text; given a
``sync`` (``torch.cuda.synchronize`` on a CUDA device), each phase closes
after it, so its seconds include the device work it queued. ``torch_trace``
takes the place of ``xla_trace``: it wraps a region in
``torch.profiler.profile`` and writes one Chrome trace, ``trace.json``, into
the given directory (chrome://tracing or Perfetto read it; a CUDA device's
kernels appear as events of category ``kernel`` under their symbols).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

TRACE_FILE = "trace.json"


@dataclass
class PhaseTimers:
    totals: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    sync: Optional[Callable[[], None]] = None

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["# phase timings"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"#   {name:20s} {tot:10.3f} s  ({n} calls, {tot/max(n,1):.4f} s/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(trace_dir=None, device="cuda"):
    """Profile the region into ``trace_dir``/trace.json (a no-op without a
    directory): CPU and CUDA activity on a CUDA device, CPU alone otherwise."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(trace_dir), TRACE_FILE))
