"""Process start to the opening of the window: kernel load (and, on a
checkout's first run, their build), the graph's generation and build, and
the warm-up pumps."""


def read(r):
    return r.setup_s
