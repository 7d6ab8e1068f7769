"""The frozen R-MAT generator and the relabeling."""
import numpy as np
import pytest

from bench import data


def test_rmat_scale16_seed0_matches_the_recorded_graph():
    # chip_smoke.py's graph_ell line on the card (R-MAT s16, seed 0, ELL):
    # 955,494 stored edges, rows padded to 6,304 slots (6,300 rounded up
    # to 8); the figures are held here as numbers, with no import of the
    # program
    src, dst, n = data.rmat_edges(16, 16, 0, 0.57, 0.19, 0.19)
    assert n == 65536 and len(src) == 16 * 65536
    keys = np.unique(src * n + dst)
    assert len(keys) == 955_494
    deg = np.bincount(keys // n, minlength=n)
    assert int(deg.max()) == 6_300
    assert int(deg.max()) + (-int(deg.max())) % 8 == 6_304


@pytest.mark.parametrize("seed", [0, 2**31 + 3, 2**40 + 1])
def test_relabeling_is_a_uniform_permutation_of_the_same_graph(seed):
    # the generator's edges under the permutation drawn from the run's
    # generator, every id used once
    src, dst, n = data.rmat_edges(10, 16, 0, 0.57, 0.19, 0.19)
    cfg = {"generator": {"kind": "rmat", "edge_factor": 16, "seed": 0,
                         "a": 0.57, "b": 0.19, "c": 0.19},
           "scale": 10, "directed": True, "storage": {}}
    e = data.make_graph(cfg, np.random.default_rng(seed))
    perm = np.random.default_rng(seed).permutation(n)
    assert sorted(perm) == list(range(n))
    assert np.array_equal(perm[src], e.src) and np.array_equal(perm[dst],
                                                               e.dst)


def test_same_seed_same_graph_other_seed_other_ids():
    cfg = {"generator": {"kind": "rmat", "edge_factor": 16, "seed": 0,
                         "a": 0.57, "b": 0.19, "c": 0.19},
           "scale": 9, "directed": False, "storage": {}}
    a = data.make_graph(cfg, np.random.default_rng(2**31 + 5))
    b = data.make_graph(cfg, np.random.default_rng(2**31 + 5))
    c = data.make_graph(cfg, np.random.default_rng(2**31 + 6))
    assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
    assert not np.array_equal(a.src, c.src)
    assert not (a.src == a.dst).any()       # undirected: loops dropped
    assert sorted(np.bincount(a.src, minlength=a.n)) == sorted(
        np.bincount(c.src, minlength=c.n))
