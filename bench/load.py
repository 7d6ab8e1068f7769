"""The general client loop: a closed loop of ``clients`` clients over the
program's ``QueryServer``, each sending its next query when its last one is
answered, read from a traffic file.

The loop pumps the server (``QueryServer.pump``) and stamps every answer
with the host clock when the pump returns it. The first ``warmup`` pumps
that answer something are set-up; one more pump follows (the traced run
starts its profiler before it), and the window opens when it returns. The
window closes at the first answering pump that returns ``seconds`` or more
after it opened, so a rate counts whole sweeps and all the time they took.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class Answer:
    """One query answered inside the window."""
    start: Optional[int]        # the seed vertex, or None for a CALL
    latency_s: float            # submit to the pump that returned it
    error: Optional[str]
    sweep: int                  # the window's answering pump that returned it
    result: object = None       # the program's Result, kept for a sample


@dataclasses.dataclass
class Window:
    t0: float                   # host clock when the window opened
    t1: float                   # ... and closed
    pumps: int                  # pumps in the window that answered
    answered: int
    answers: List[Answer]       # every answer (results only for the kept)
    kept: List[Answer]          # a uniform sample drawn from the seed
    stats0: dict                # the server's counters at t0 and t1
    stats1: dict

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class ClosedLoop:
    """Drives ``server`` with ``traffic``'s query from ``clients`` clients.
    ``starts`` holds the vertices a seeded query may start from; ``rng``
    (from the run's seed) draws them and the kept sample."""

    def __init__(self, server, traffic: dict, starts, rng):
        self.srv = server
        self.text = traffic["query"]
        self.clients = int(traffic["clients"])
        self.seeded = bool(traffic.get("seeded", False))
        self.warmup = int(traffic["warmup_pumps"])
        self.keep = int(traffic["check"]["sample"])
        self.starts = np.asarray(starts, np.int64)
        self.rng = rng
        self._pending = {}

    def _submit(self):
        s = (int(self.starts[self.rng.integers(len(self.starts))])
             if self.seeded else None)
        qid = self.srv.submit(self.text,
                              seeds=[s] if s is not None else None)
        self._pending[qid] = (s, time.perf_counter())

    def run(self, seconds: float,
            before_window: Callable[[], None] = lambda: None,
            window_open: Callable[[], None] = lambda: None,
            window_close: Callable[[], None] = lambda: None) -> Window:
        """Set-up pumps, then the window; returns what it answered. The
        three hooks run at the end of set-up, as the window opens and as
        it closes."""
        for _ in range(self.clients):
            self._submit()
        answering = 0
        win = None
        while True:
            out = self.srv.pump()
            t = time.perf_counter()
            if not out:
                continue
            if win is not None:
                for qid, res in out.items():
                    s, ts = self._pending[qid]
                    a = Answer(s, t - ts, res.error, win.pumps)
                    i = len(win.answers)
                    win.answers.append(a)
                    if i < self.keep:       # reservoir sample
                        a.result = res
                        win.kept.append(a)
                    else:
                        j = int(self.rng.integers(i + 1))
                        if j < self.keep:
                            a.result = res
                            win.kept[j] = a
                win.pumps += 1
            for qid in out:
                del self._pending[qid]
                self._submit()
            answering += 1
            if win is None:
                if answering == self.warmup:
                    before_window()
                elif answering == self.warmup + 1:
                    window_open()
                    win = Window(t, t, 0, 0, [], [], dict(self.srv.stats),
                                 {})
            elif t - win.t0 >= seconds:
                window_close()
                win.t1 = t
                win.stats1 = dict(self.srv.stats)
                win.answered = len(win.answers)
                return win

    def drain(self) -> None:
        """Finish what is queued and in flight (after the window)."""
        self.srv.flush()
        self._pending.clear()
