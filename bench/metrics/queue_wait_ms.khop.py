"""Submit-to-launch wait a query, from the server's counters
(``QueryServer.stats["queue_wait_s_total"]``) over the window."""


def read(r):
    q = r.delta("queries")
    return r.delta("queue_wait_s_total") / q * 1e3 if q else None
