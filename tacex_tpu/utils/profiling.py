"""Profiling and timing utilities.

Counterpart of the reference's timing stack (SURVEY §5): libuipc's
hierarchical ``Timer`` report (reference uipc_sim.py:286-293) and the
benchmark harness's wall-clock splits. Provides:

  * :class:`Timer` — nestable named scopes with a hierarchical report;
    device work is fenced with ``block_until_ready`` so scopes measure real
    execution, not dispatch;
  * :func:`trace` — context manager around ``jax.profiler`` emitting a
    TensorBoard-loadable trace directory for deep kernel-level analysis;
  * :func:`gpu_card` — the GPU's name and power limit, to report beside
    every measurement.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict

import jax


class Timer:
    """Nested scope timer with an aggregated hierarchical report."""

    def __init__(self):
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._stack: list[str] = []

    @contextlib.contextmanager
    def scope(self, name: str, fence=None):
        """Time a scope. Pass ``fence`` (any pytree of arrays) to block on
        device completion before closing the scope."""
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                jax.block_until_ready(fence)
            self._totals[path] += time.perf_counter() - t0
            self._counts[path] += 1
            self._stack.pop()

    def report(self, as_json: bool = False):
        entries = {
            path: {
                "total_ms": round(t * 1e3, 3),
                "count": self._counts[path],
                "avg_ms": round(t / max(self._counts[path], 1) * 1e3, 3),
            }
            for path, t in sorted(self._totals.items())
        }
        if as_json:
            return entries
        lines = []
        for path, e in entries.items():
            indent = "  " * path.count("/")
            lines.append(
                f"{indent}{path.split('/')[-1]}: {e['total_ms']:.2f} ms "
                f"({e['count']}x, avg {e['avg_ms']:.2f} ms)"
            )
        return "\n".join(lines)

    def reset(self):
        self._totals.clear()
        self._counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def gpu_card() -> str:
    """The machine's GPUs as ``nvidia-smi`` names them, with their power
    limits ("NVIDIA H100 80GB HBM3, 700.00 W"; several joined by "; "). A
    card set below its maximum power runs slower under load, so every
    measurement is reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
