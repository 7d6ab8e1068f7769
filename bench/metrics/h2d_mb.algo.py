"""Bytes copied from the host to the card (``QueryServer.stats
["h2d_bytes"]``, counted by ``core.xfer.to_device``: the SpGEMM plan's
upload, its mask selections, the output tiles' coordinates) a CALL
answered in the window, in MB (10^6 bytes)."""
from bench import program


def read(r):
    v = program.counter(r, "h2d_bytes")
    if v is None or not r.window.answered:
        return None
    return v / r.window.answered * 1e-6
