"""Host time in the SpGEMM's symbolic plan (``core.bsr.spgemm_symbolic``)
a call answered in the window (bench spans)."""

SPANS = {"plan": "repro_torch.core.bsr:spgemm_symbolic"}


def read(r):
    if r.trace is None or not r.trace.span_count("plan"):
        return None
    return r.trace.span_s("plan") / r.window.answered * 1e3
