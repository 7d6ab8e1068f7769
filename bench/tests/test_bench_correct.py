"""What decides ``correct``, driven through a whole run on the CPU at a
small size (the harness's look for a card skipped): sound runs pass; the
control (the reference in bfloat16 in the program's place) and each fault
a cell can have, planted under the timed path, come out not correct."""
import numpy as np
import pytest

from bench.tests import control, helpers  # helpers puts src on sys.path
from repro_torch.query import executor as X
from repro_torch.query.executor import Result

CELLS = ["khop2-graph500-s16", "tc-graphchallenge-s15",
         "pagerank-graphchallenge-s15"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = helpers.run_small(cell)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    # the triangle cell's wedge counts pass bfloat16's 256 only on a
    # denser graph at this scale (scale 15 at edge factor 16 on the card)
    out = helpers.run_small(cell, control=control.bf16_answers,
                            edge_factor=64 if cell.startswith("tc") else None)
    assert out["correct"] is False, out["checks"]


def _unchanged_state(monkeypatch, cell):
    """The step returns its state unchanged: a hop that does not move
    the frontier, a product that returns its left operand."""
    if cell.startswith("khop"):
        monkeypatch.setattr(X.ExecutionContext, "expand",
                            lambda self, B, e, sr, dst: B)
    else:
        from repro_torch.core import grb
        mxm, mxv = grb.mxm, grb.mxv
        monkeypatch.setattr(grb, "mxm", lambda A, B, *a, **k:
                            B if isinstance(B, grb.GBMatrix)
                            and B.fmt == "bsr" else mxm(A, B, *a, **k))
        monkeypatch.setattr(grb, "mxv", lambda A, x, *a, **k: x)


def _half_batch(monkeypatch, cell):
    """Half of each sweep's columns left out."""
    traverse = X.ExecutionContext.traverse

    def half(self, p, seeds, keep=None):
        B = traverse(self, p, seeds, keep=keep)
        B[:, B.shape[1] // 2:] = 0
        return B
    monkeypatch.setattr(X.ExecutionContext, "traverse", half)


def _altered_answer(monkeypatch, cell):
    """Every answer altered where it is produced (by one in a count, by
    1e-3 in one vertex's rank)."""
    project = X.ExecutionContext.project

    def altered(self, p, seeds, B):
        r = project(self, p, seeds, B)
        rows = list(r.rows)
        if len(rows) == 1:
            rows[0] = (rows[0][0] + 1,)
        else:
            rows[0] = (rows[0][0], rows[0][1] + 1e-3)
        return Result(r.columns, rows, r.error)
    monkeypatch.setattr(X.ExecutionContext, "project", altered)


FAULTS = {
    "unchanged_state": (_unchanged_state, CELLS),
    "half_batch": (_half_batch, ["khop2-graph500-s16"]),
    "altered_answer": (_altered_answer, CELLS),
}


@pytest.mark.parametrize("fault,cell", [(f, c) for f, (_, cs) in
                                        FAULTS.items() for c in cs])
def test_fault_under_the_timed_path_is_not_correct(monkeypatch, fault, cell):
    FAULTS[fault][0](monkeypatch, cell)
    out = helpers.run_small(cell)
    assert out["correct"] is False, out["checks"]


def test_error_answers_are_failed_and_not_correct(monkeypatch):
    def boom(self, p, seeds, B):
        raise ValueError("planted")
    monkeypatch.setattr(X.ExecutionContext, "project", boom)
    out = helpers.run_small("khop2-graph500-s16")
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] > 0
    assert out["checks"]["errors"]["value"] == out["failed"]
