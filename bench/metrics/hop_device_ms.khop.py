"""Device time of the operations launched inside
``ExecutionContext.traverse``, a sweep; launches are matched to the span
by the profiler's launch correlation."""

SPANS = {"traverse": "repro_torch.query.executor:ExecutionContext.traverse"}


def read(r):
    if r.trace is None or not r.trace.span_count("traverse"):
        return None
    dev = r.trace.device_s("traverse")
    return dev / r.trace.span_count("traverse") * 1e3 if dev > 0 else None
