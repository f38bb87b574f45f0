"""Hierarchical wall-clock profiler (a copy of
:mod:`srba_tpu.utils.profiler`) — analog of the reference's
``mrpt::utils::CTimeLogger`` member (``m_profiler``) wrapping every pipeline
stage, with the mean/min/max dump table of ``srba-slam --profile-stats``
(SURVEY.md §6, Tracing/profiling)."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class _Stat:
    count: int = 0
    total: float = 0.0
    t_min: float = float("inf")
    t_max: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.t_min = min(self.t_min, dt)
        self.t_max = max(self.t_max, dt)


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stats: Dict[str, _Stat] = defaultdict(_Stat)
        # Event counters (e.g. the global PGO's device reads per solve).
        self.counters: Dict[str, int] = defaultdict(int)
        self._stack: List[str] = []

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counters[name] += n

    @contextmanager
    def scope(self, name: str):
        if not self.enabled:
            yield
            return
        self._stack.append(name)
        key = ".".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats[key].add(time.perf_counter() - t0)
            self._stack.pop()

    def report(self) -> str:
        """Mean/min/max table like the reference profiler dump."""
        lines = [f"{'scope':<48}{'count':>7}{'mean ms':>10}"
                 f"{'min ms':>10}{'max ms':>10}{'total s':>10}"]
        for key in sorted(self.stats):
            s = self.stats[key]
            lines.append(
                f"{key:<48}{s.count:>7}{1e3 * s.total / max(s.count, 1):>10.3f}"
                f"{1e3 * s.t_min:>10.3f}{1e3 * s.t_max:>10.3f}"
                f"{s.total:>10.3f}")
        for key in sorted(self.counters):
            lines.append(f"{key:<48}{self.counters[key]:>7}")
        return "\n".join(lines)

    def mean(self, key: str) -> float:
        s = self.stats.get(key)
        return s.total / s.count if s and s.count else 0.0
