"""Terminal progress bar for data load/batchify (reference:
liteasr/utils/progress_bar.py:9-75)."""

import sys
import time


class ProgressBar:
    def __init__(self, total: int, title: str = "", width: int = 40,
                 stream=None):
        self.total = max(total, 1)
        self.title = title
        self.width = width
        self.stream = stream or sys.stderr
        self.start = time.perf_counter()
        self._last_render = 0.0

    def update(self, done: int) -> None:
        now = time.perf_counter()
        if done < self.total and now - self._last_render < 0.1:
            return
        self._last_render = now
        frac = min(done / self.total, 1.0)
        filled = int(self.width * frac)
        bar = "#" * filled + "-" * (self.width - filled)
        elapsed = now - self.start
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        self.stream.write(
            f"\r{self.title} [{bar}] {done}/{self.total} "
            f"({frac:6.1%}) eta {eta:5.1f}s")
        if done >= self.total:
            self.stream.write("\n")
        self.stream.flush()
