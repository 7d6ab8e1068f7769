"""SpGEMM tile tasks planned by ``core.bsr.spgemm_symbolic``, before grid
padding (``QueryServer.stats["plan_tasks"]``), a CALL answered in the
window: the work count beside ``plan_ms.algo``."""
from bench import program


def read(r):
    v = program.counter(r, "plan_tasks")
    if v is None or not r.window.answered:
        return None
    return v / r.window.answered
