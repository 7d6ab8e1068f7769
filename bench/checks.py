"""What decides ``correct``: the answers the window returned, held against
the plain references in ``reference/``.

Each kind of answer (a traffic file's ``answer``) has a ``Kind``: how to
read a value from the program's ``Result``, the reference values for the
kept answers, and the numbers compared, each against its limit from the
traffic file's ``limits``. ``control`` is the reference computed in a lower
precision (``reference.precision.bfloat16``): put in the program's place,
it has to fail.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

from bench import work
from bench.reference import khop, pagerank, precision, triangles


@dataclasses.dataclass
class Kind:
    value: Callable             # Result -> the answer
    reference: Callable         # (A, traffic, starts, rounding) -> answers
    compare: Callable           # (got, want) -> {number: reading}
    work: Callable              # (A, traffic, want, window) -> the
    #                             (bytes, ops) of the work launched in it


def _khop_reference(A, traffic, starts, rounding):
    return list(khop.khop_counts(A, np.asarray(starts), traffic["hops"],
                                 rounding=rounding))


def _exact_wrong(got, want):
    return {"wrong_answers": int(sum(int(g) != int(w)
                                     for g, w in zip(got, want)))}


def _khop_work(A, traffic, want, win):
    done = [a for a in win.answers if a.error is None]
    return work.khop_sweeps(A, [a.start for a in done],
                            [a.sweep for a in done], traffic["hops"])


def _triangles_reference(A, traffic, starts, rounding):
    return [triangles.triangle_count(A, rounding=rounding)] * len(starts)


def _triangles_compare(got, want):
    return {"triangle_gap": int(max(abs(int(g) - int(w))
                                    for g, w in zip(got, want)))}


def _triangles_work(A, traffic, want, win):
    b, ops = work.triangles(A.shape[0], A.nnz, want[0])
    return b * win.answered, ops * win.answered


def _ranks(res) -> np.ndarray:
    rows = np.asarray(res.rows, dtype=np.float64)
    out = np.full(len(rows), np.nan)
    out[rows[:, 0].astype(np.int64)] = rows[:, 1]
    return out


def _pagerank_reference(A, traffic, starts, rounding):
    r = pagerank.pagerank(A, traffic["alpha"], traffic["iters"],
                          rounding=None if rounding is precision.exact
                          else rounding)
    return [r] * len(starts)


def _pagerank_compare(got, want):
    l1 = [float(np.abs(g - w).sum()) if len(g) == len(w) else np.inf
          for g, w in zip(got, want)]
    return {"rank_l1": max(l1)}


def _pagerank_work(A, traffic, want, win):
    b, ops = work.pagerank(A.shape[0], A.nnz, traffic["iters"])
    return b * win.answered, ops * win.answered


KINDS: Dict[str, Kind] = {
    "khop_count": Kind(lambda res: res.scalar(), _khop_reference,
                       _exact_wrong, _khop_work),
    "triangles": Kind(lambda res: res.scalar(), _triangles_reference,
                      _triangles_compare, _triangles_work),
    "pagerank": Kind(_ranks, _pagerank_reference, _pagerank_compare,
                     _pagerank_work),
}


def judge(traffic: dict, got: List, want: List, errors: int) -> Dict:
    """``{number: {"value", "limit"}}``: the count of error answers, then
    the kept answers ``got`` against ``want``. A value that is not finite
    reads 1e300."""
    out = {"errors": {"value": errors, "limit": 0}}
    for k, v in KINDS[traffic["answer"]].compare(got, want).items():
        out[k] = {"value": v if np.isfinite(v) else 1e300,
                  "limit": traffic["limits"][k]}
    return out


def passed(numbers: Dict) -> bool:
    """Every number at or under its limit."""
    return all(v["value"] <= v["limit"] for v in numbers.values())
