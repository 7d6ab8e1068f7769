"""Copies from the card to the host (``QueryServer.stats["d2h_copies"]``,
counted by ``core.xfer.to_host``) a sweep answered in the window."""
from bench import program


def read(r):
    v = program.counter(r, "d2h_copies")
    if v is None or not r.window.pumps:
        return None
    return v / r.window.pumps
