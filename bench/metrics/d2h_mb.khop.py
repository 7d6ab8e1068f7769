"""Bytes copied from the card to the host (``QueryServer.stats
["d2h_bytes"]``, counted by ``core.xfer.to_host``) a sweep answered in the
window, in MB (10^6 bytes)."""
from bench import program


def read(r):
    v = program.counter(r, "d2h_bytes")
    if v is None or not r.window.pumps:
        return None
    return v / r.window.pumps * 1e-6
