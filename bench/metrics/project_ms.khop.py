"""Host time in ``ExecutionContext.project`` a sweep answered in the
window (bench spans)."""

SPANS = {"project": "repro_torch.query.executor:ExecutionContext.project"}


def read(r):
    if r.trace is None or not r.trace.span_count("project"):
        return None
    return r.trace.span_s("project") / r.window.pumps * 1e3
