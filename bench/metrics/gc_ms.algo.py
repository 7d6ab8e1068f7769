"""Host time in Python's garbage collections (the program's ``gc`` spans)
a CALL answered in the window."""
from bench import program


def read(r):
    d = program.spans(r, "gc")
    if d is None or not r.window.answered:
        return None
    return sum(d) / r.window.answered * 1e3
