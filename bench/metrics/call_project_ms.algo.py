"""Host time in ``ExecutionContext._call_project`` (a CALL's rows) a call
answered in the window (bench spans)."""

SPANS = {"call_project":
         "repro_torch.query.executor:ExecutionContext._call_project"}


def read(r):
    if r.trace is None or not r.trace.span_count("call_project"):
        return None
    return r.trace.span_s("call_project") / r.window.answered * 1e3
