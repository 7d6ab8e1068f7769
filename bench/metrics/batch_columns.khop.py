"""Live frontier columns a sweep, from the server's counters
(``QueryServer.stats``) over the window."""


def read(r):
    b = r.delta("batches")
    return r.delta("batched_width_total") / b if b else None
