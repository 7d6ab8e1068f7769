"""The window over the CALL algo.* calls answered in it (host clock)."""


def read(r):
    return r.window.seconds / r.window.answered * 1e3
