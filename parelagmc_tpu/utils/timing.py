"""Named-scope wall-clock timers.

Batched JAX analog of parelag::TimeManager (used throughout the reference,
e.g. /root/reference/src/PDESampler.cpp:80-83, src/MLMC_Manager.cpp:72-77).
Timer values feed back into the MLMC algorithm as the per-level cost model
when cost_model == "walltime" (reference: src/MLMC_Manager.cpp:367-383).

Note on JAX: device execution is asynchronous, so any timer that is supposed
to measure device work must wrap the timed region so that result arrays are
block_until_ready()-ed before the timer stops. The `timed` context manager
takes an optional `block` pytree for this.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict


class _Watch:
    __slots__ = ("elapsed", "count", "last")

    def __init__(self) -> None:
        self.elapsed = 0.0
        self.count = 0
        self.last = 0.0


class TimeManager:
    """Process-global registry of named accumulating timers."""

    _watches: Dict[str, _Watch] = OrderedDict()

    @classmethod
    def reset(cls) -> None:
        cls._watches = OrderedDict()

    @classmethod
    def get_watch(cls, name: str) -> _Watch:
        if name not in cls._watches:
            cls._watches[name] = _Watch()
        return cls._watches[name]

    @classmethod
    def elapsed(cls, name: str) -> float:
        """Total accumulated seconds for timer `name` (0.0 if never used)."""
        w = cls._watches.get(name)
        return w.elapsed if w is not None else 0.0

    @classmethod
    def last(cls, name: str) -> float:
        """Seconds of the most recent timed region for `name` (0.0 if unused)."""
        w = cls._watches.get(name)
        return w.last if w is not None else 0.0

    @classmethod
    @contextmanager
    def timed(cls, name: str, block=None):
        """Context manager accumulating wall time into timer `name`.

        If `block` is a callable it is invoked on exit and its return value
        is block_until_ready()-ed (when possible) before the timer stops, so
        asynchronous device work is included in the measurement.
        """
        w = cls.get_watch(name)
        t0 = time.perf_counter()
        try:
            yield w
        finally:
            if block is not None:
                out = block() if callable(block) else block
                _block_until_ready(out)
            w.last = time.perf_counter() - t0
            w.elapsed += w.last
            w.count += 1

    @classmethod
    def print_table(cls, stream=None) -> str:
        lines = ["%-60s %12s %8s" % ("Timer", "seconds", "calls")]
        lines.append("-" * 82)
        for name, w in cls._watches.items():
            lines.append("%-60s %12.6f %8d" % (name, w.elapsed, w.count))
        out = "\n".join(lines)
        if stream is not None:
            print(out, file=stream)
        return out


def _block_until_ready(tree) -> None:
    try:
        import jax

        jax.block_until_ready(tree)
    except Exception:
        pass


class SteadyCostLedger:
    """Per-level walltime ledger that excludes each level's FIRST timed
    batch in this process from the cost model.

    Why: the first execution of a compiled program pays one-time costs
    (program load, autotuning, allocator warm-up) that can dwarf a steady
    batch. The reference's walltime cost model
    (/root/reference/src/MLMC_Manager.cpp:367-383) has no such overhead
    because there is no JIT; including it here distorts the optimal N_l
    allocation exactly at small adaptive sample counts. The first batch's
    walltime is ledgered separately (observable for diagnostics), and the
    cost model uses only steady-state batches; when a level has run just
    one batch the caller falls back to the all-inclusive timer.

    Checkpoint/resume: the accumulated arrays round-trip through
    state()/load(); the "first batch seen" marker is deliberately
    per-process (a resumed run pays program load again, and its first
    post-resume batch is excluded again).
    """

    def __init__(self, nlevels: int) -> None:
        import numpy as np

        self.time = np.zeros(nlevels)
        self.nsamples = np.zeros(nlevels, dtype=np.int64)
        self.first_time = np.zeros(nlevels)
        self.first_nsamples = np.zeros(nlevels, dtype=np.int64)
        self._seen_this_process: set = set()

    def add_batch(self, level: int, dt: float, nsamples: int) -> None:
        if level not in self._seen_this_process:
            self._seen_this_process.add(level)
            self.first_time[level] += float(dt)
            self.first_nsamples[level] += int(nsamples)
        else:
            self.time[level] += float(dt)
            self.nsamples[level] += int(nsamples)

    def cost_per_sample(
        self, level: int, fallback_time: float, fallback_n: int
    ) -> float:
        """Steady-state seconds per sample; falls back to the all-inclusive
        (program-load-bearing) timer when no steady batch exists yet."""
        if self.nsamples[level] > 0:
            return float(self.time[level]) / float(self.nsamples[level])
        return float(fallback_time) / max(int(fallback_n), 1)

    def state(self) -> dict:
        return {
            "cost_ss_time": self.time,
            "cost_ss_n": self.nsamples,
            "cost_first_time": self.first_time,
            "cost_first_n": self.first_nsamples,
        }

    def load(self, data) -> None:
        """Restore from an npz mapping; silently keeps zeros for pre-ledger
        checkpoints (their cost falls back to the all-inclusive timer)."""
        if "cost_ss_time" in getattr(data, "files", data):
            self.time = data["cost_ss_time"].copy()
            self.nsamples = data["cost_ss_n"].copy()
            self.first_time = data["cost_first_time"].copy()
            self.first_nsamples = data["cost_first_n"].copy()
