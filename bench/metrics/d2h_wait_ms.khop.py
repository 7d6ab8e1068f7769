"""Host time in the program's ``d2h`` spans (``core.xfer.to_host``: the
frontier's copy in ``QueryServer._finish`` and the label masks of
``ExecutionContext.node_mask``), which wait for the device's work before
them, a sweep answered in the window (program spans)."""
from bench import program


def read(r):
    d = program.spans(r, "d2h")
    if d is None or not r.window.pumps:
        return None
    return sum(d) / r.window.pumps * 1e3
