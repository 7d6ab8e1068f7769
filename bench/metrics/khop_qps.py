"""k-hop queries answered in the window over the window's length (host
clock, client side)."""


def read(r):
    return r.window.answered / r.window.seconds
