"""ProgressMeter: banner + rate + ETA line on stderr.

Re-implements the reference's threaded progress meter
(reference: src/algorithms/progress.hpp:20-75): an atomic counter and a
500 ms refresher printing '\\r<banner> <pct>% @ <rate> elapsed/remain',
gated by -P/--progress on the subcommands."""

from __future__ import annotations

import sys
import threading
import time


def _fmt_time(seconds: float) -> str:
    seconds = max(0.0, seconds)
    h, rem = divmod(int(seconds), 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


class ProgressMeter:
    """Started at construction: prints the line at once, then every
    `INTERVAL` seconds while the count moves, and at `finish`."""

    INTERVAL = 0.5

    def __init__(self, total: int, banner: str):
        self.total = max(int(total), 1)
        self.banner = banner
        self.completed = 0
        self._start = time.monotonic()
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._print()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = -1
        while not self._done.wait(self.INTERVAL):
            with self._lock:
                cur = self.completed
            if cur != last:
                self._print()
                last = cur

    def _print(self):
        elapsed = time.monotonic() - self._start
        rate = self.completed / elapsed if elapsed > 0 else 0.0
        remain = (self.total - self.completed) / rate if rate > 0 else 0.0
        pct = 100.0 * self.completed / self.total
        sys.stderr.write(
            f"\r{self.banner} {pct:5.2f}% @ {rate:.2e} bp/s "
            f"elapsed: {_fmt_time(elapsed)} remain: {_fmt_time(remain)}"
        )
        sys.stderr.flush()

    def increment(self):
        with self._lock:
            self.completed += 1

    def finish(self):
        with self._lock:
            self.completed = self.total
        self._done.set()
        self._thread.join(timeout=2.0)
        self._print()
        sys.stderr.write("\n")
        sys.stderr.flush()
