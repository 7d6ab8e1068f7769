"""The least time the card could take for the window's CALL algo.* calls
(the larger of the needed bytes and operations at the data-sheet rates,
``work.triangles`` / ``work.pagerank``) over the device time of the
operations the calls launch (inside ``traverse``), in percent."""
from bench import peaks

SPANS = {"traverse": "repro_torch.query.executor:ExecutionContext.traverse"}


def read(r):
    if r.trace is None:
        return None
    dev = r.trace.device_s("traverse")
    return 100.0 * peaks.bound_s(*r.work) / dev if dev > 0 else None
