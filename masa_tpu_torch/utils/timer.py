"""Taken from ``masa_tpu/utils/timer.py`` (the JAX reference).

Named-event stopwatch + background progress ticker
(common/Timer.hpp:33-66, common/RecurrentTimer.cpp:27-80)."""

from __future__ import annotations

import threading
import time


class Timer:
    """Accumulates wall time per named event; prints per-stage statistics
    with MCUPS like the reference's statistics files."""

    def __init__(self):
        self.events: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._mark = time.time()

    def create_event(self, name: str) -> str:
        self.events.setdefault(name, 0.0)
        self.counts.setdefault(name, 0)
        return name

    def init(self) -> None:
        self._mark = time.time()

    def event_record(self, name: str) -> float:
        now = time.time()
        dt = now - self._mark
        self._mark = now
        self.events[name] = self.events.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return dt

    def total(self) -> float:
        return sum(self.events.values())

    def print_statistics(self, fh, cells: int | None = None) -> float:
        total = self.total()
        for name, t in self.events.items():
            fh.write(f"  {name:>16}: {t*1000:10.3f} ms "
                     f"({self.counts[name]} events)\n")
        fh.write(f"  {'TOTAL':>16}: {total*1000:10.3f} ms\n")
        if cells is not None and total > 0:
            fh.write(f"  {'MCUPS':>16}: {cells/1e6/total:10.2f}\n")
        return total * 1000


class RecurrentTimer:
    """Background thread invoking a callback every `interval` seconds (the
    stage-1 progress line every 2 s, sw_stage1.cpp:315,378)."""

    def __init__(self, interval: float, callback):
        self.interval = interval
        self.callback = callback
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        def run():
            while not self._stop.wait(self.interval):
                self.callback()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval + 1)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
