"""Console progress bar (counterpart of aphantasia_tpu.progress)."""
from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, task_num: int = 0):
        self.task_num = task_num
        self.completed = 0
        self.start = time.time()

    def upd(self, msg=None):
        self.completed += 1
        elapsed = time.time() - self.start + 1e-9
        fps = self.completed / elapsed
        if self.task_num > 0:
            remaining = (self.task_num - self.completed) / max(fps, 1e-9)
            eta = time.strftime("%H:%M:%S", time.gmtime(remaining))
            filled = int(24 * self.completed / self.task_num)
            bar = ">" * filled + "-" * (24 - filled)
            line = (f"\r [{bar}] {self.completed}/{self.task_num} "
                    f"{fps:.2f} it/s  eta {eta}")
        else:
            line = f"\r {self.completed} done, {fps:.2f} it/s"
        if msg:
            line += f"  {msg}"
        sys.stderr.write(line)
        if self.completed == self.task_num:
            sys.stderr.write("\n")
        sys.stderr.flush()
