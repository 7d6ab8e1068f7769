"""The least time the card could take for the window's sweeps (the bytes
they need at the data-sheet bandwidth, ``work.khop_sweeps``: each hop the
out-edges of its frontier's vertices and the visited words) over the device
time of their ``traverse`` launches, in percent."""
from bench import peaks

SPANS = {"traverse": "repro_torch.query.executor:ExecutionContext.traverse"}


def read(r):
    if r.trace is None:
        return None
    dev = r.trace.device_s("traverse")
    need = peaks.bound_s(*r.work)
    return 100.0 * need / dev if dev > 0 and need > 0 else None
