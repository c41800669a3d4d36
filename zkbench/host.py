"""What the host did while the window ran, printed on standard error beside
every run's result: the process's and its main thread's CPU seconds, and
the Python garbage collector's collections and seconds by generation.
Where ``round_s`` moves between runs of one seed while the main thread's
CPU seconds fill the window alike, the same work ran at another speed of
the host's cores."""

from __future__ import annotations

import gc
import os
import time


class HostWatch:
    """Started at the window's start, read at its close."""

    def __init__(self):
        self.gc_n = [0, 0, 0]
        self.gc_s = [0.0, 0.0, 0.0]
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_n[info["generation"]] += 1
            self.gc_s[info["generation"]] += time.perf_counter() - self._t
            self._t = None

    def start(self) -> None:
        self.wall0, self.thread0, self.cpu0 = time.perf_counter(), time.thread_time(), os.times()
        gc.callbacks.append(self._gc)

    def stop(self) -> str:
        gc.callbacks.remove(self._gc)
        cpu = os.times()
        own = (cpu.user - self.cpu0.user) + (cpu.system - self.cpu0.system)
        return (f"# host: wall {time.perf_counter() - self.wall0:.3f} s, process cpu {own:.3f} s, "
                f"main thread cpu {time.thread_time() - self.thread0:.3f} s; "
                f"gc collections {'/'.join(map(str, self.gc_n))} in "
                f"{'/'.join(f'{s:.3f}' for s in self.gc_s)} s (generations 0/1/2)")
