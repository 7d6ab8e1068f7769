"""Elastic / fault-tolerant launch logic (control plane). Port of
``repro.launch.elastic``.

On a real fleet each pod runs one process; this module holds the pure logic
(mesh re-planning, restart decisions, straggler policy) so it is unit-testable
without 512 real hosts:

  * ``plan_mesh(n_healthy_chips)``: largest (data, model) grid that fits the
    survivors while keeping "model"=16 (TP degree is fixed by memory); data
    shrinks elastically — ``train.checkpoint.restore(shardings=, mesh=)``
    re-places the checkpoint onto the new mesh.
  * ``RestartPolicy``: heartbeat bookkeeping; a worker that misses
    ``timeout_s`` is dead; >0 dead => restart from LATEST with a new plan.
  * Straggler mitigation: workers report step latency; persistent p95
    outliers (> ``straggler_factor`` x median) are cordoned at the next
    restart boundary (standard backup-worker strategy).

The clock is injectable (``clock=``), so a test or a simulated fleet drives
time itself.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple


def plan_mesh(n_healthy_chips: int, model_degree: int = 16,
              pod_size: int = 256) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest mesh (pods x data x model) runnable on the healthy chips."""
    if n_healthy_chips < model_degree:
        raise RuntimeError("fewer chips than the TP degree: cannot resume")
    pods = n_healthy_chips // pod_size
    if pods >= 2:
        data = pod_size // model_degree
        return (pods, data, model_degree), ("pod", "data", "model")
    data = n_healthy_chips // model_degree
    return (data, model_degree), ("data", "model")


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    step_latencies: list


class RestartPolicy:
    def __init__(self, timeout_s: float = 60.0, straggler_factor: float = 2.0,
                 clock=time.monotonic):
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.clock = clock
        self.workers: Dict[str, WorkerState] = {}
        self.cordoned: set = set()

    def heartbeat(self, worker: str, step_latency_s: Optional[float] = None):
        st = self.workers.setdefault(worker, WorkerState(self.clock(), []))
        st.last_heartbeat = self.clock()
        if step_latency_s is not None:
            st.step_latencies.append(step_latency_s)
            st.step_latencies = st.step_latencies[-100:]

    def dead_workers(self):
        now = self.clock()
        return sorted(w for w, st in self.workers.items()
                      if now - st.last_heartbeat > self.timeout_s
                      and w not in self.cordoned)

    def stragglers(self):
        lats = {w: sorted(st.step_latencies)
                for w, st in self.workers.items() if st.step_latencies}
        if len(lats) < 2:
            return []
        medians = {w: l[len(l) // 2] for w, l in lats.items()}
        global_median = sorted(medians.values())[len(medians) // 2]
        return sorted(w for w, m in medians.items()
                      if m > self.straggler_factor * global_median)

    def should_restart(self) -> bool:
        return bool(self.dead_workers())

    def plan_restart(self, chips_per_worker: int = 256):
        """Cordon dead + persistent stragglers; re-plan the mesh."""
        for w in self.dead_workers() + self.stragglers():
            self.cordoned.add(w)
        healthy = [w for w in self.workers if w not in self.cordoned]
        return plan_mesh(len(healthy) * chips_per_worker)
