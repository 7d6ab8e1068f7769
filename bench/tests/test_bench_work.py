"""The needed work the rooflines divide by, against brute force, and the
client loop's record of which sweep answered each query."""
import numpy as np
import pytest

from bench import data, load, work
from bench.reference import graph


def _graph(scale, seed):
    cfg = {"generator": {"kind": "rmat", "edge_factor": 8, "seed": seed,
                         "a": 0.57, "b": 0.19, "c": 0.19},
           "scale": scale, "directed": True, "storage": {}}
    e = data.make_graph(cfg, np.random.default_rng(seed + 7))
    return e, graph.simple_csr(e.src, e.dst, e.n)


def _brute_bytes(e, A, starts, sweeps, hops):
    adj = [set() for _ in range(e.n)]
    for s, d in zip(e.src, e.dst):
        adj[s].add(d)
    edges = 0
    for sw in sorted(set(sweeps)):
        cols = [s for s, w in zip(starts, sweeps) if w == sw]
        levels = [[{s} for s in cols]]
        seen = [{s} for s in cols]
        for _ in range(hops - 1):
            nxt = []
            for j, f in enumerate(levels[-1]):
                new = {v for u in f for v in adj[u]} - seen[j]
                seen[j] |= new
                nxt.append(new)
            levels.append(nxt)
        for level in levels:
            edges += sum(len(adj[v]) for v in set().union(*level))
    return 4 * edges + hops * 2 * 4 * e.n * len(starts) / 32


@pytest.mark.parametrize("scale,hops,per_sweep", [(6, 1, 3), (6, 2, 5),
                                                  (7, 2, 22), (7, 3, 4),
                                                  (8, 6, 9)])
def test_khop_bytes_count_the_frontiers_edges(scale, hops, per_sweep):
    e, A = _graph(scale, scale)
    rng = np.random.default_rng(scale * 10 + hops)
    starts = rng.choice(np.unique(e.src), 40)
    sweeps = np.arange(40) // per_sweep
    got, ops = work.khop_sweeps(A, starts, sweeps, hops)
    assert ops == 0.0
    assert got == pytest.approx(_brute_bytes(e, A, list(starts),
                                             list(sweeps), hops))


def test_khop_bytes_read_a_shared_frontier_once_a_sweep():
    e, A = _graph(7, 3)
    s = int(np.unique(e.src)[0])
    one, _ = work.khop_sweeps(A, [s], [0], 2)
    twice_one_sweep, _ = work.khop_sweeps(A, [s, s], [0, 0], 2)
    twice_two_sweeps, _ = work.khop_sweeps(A, [s, s], [0, 1], 2)
    words = 2 * 2 * 4 * e.n / 32
    assert twice_two_sweeps == pytest.approx(2 * one)
    assert twice_one_sweep == pytest.approx(one + words)


def test_khop_bytes_of_a_sink_are_the_visited_words_alone():
    e, A = _graph(7, 4)
    sink = int(np.setdiff1d(np.arange(e.n), e.src)[0])
    got, _ = work.khop_sweeps(A, [sink], [0], 6)
    assert got == pytest.approx(6 * 2 * 4 * e.n / 32)


class _PipelinedServer:
    """Answers, one pump later, at most ``width`` of the queries queued."""

    def __init__(self, width):
        self.width, self.queue, self.inflight, self.next = width, [], [], 0
        self.stats = {"queries": 0}

    def submit(self, text, seeds=None):
        self.next += 1
        self.queue.append(self.next)
        return self.next

    def pump(self):
        done, self.inflight = self.inflight, self.queue[:self.width]
        self.queue = self.queue[self.width:]
        self.stats["queries"] += len(done)

        class R:
            error = None
        return {q: R() for q in done}

    def flush(self):
        while self.queue or self.inflight:
            self.pump()


@pytest.mark.parametrize("clients,width", [(22, 512), (64, 16)])
def test_each_answer_names_the_sweep_that_returned_it(clients, width):
    traffic = {"query": "q", "clients": clients, "seeded": True,
               "warmup_pumps": 2, "check": {"sample": 8}}
    loop = load.ClosedLoop(_PipelinedServer(width), traffic,
                           np.arange(100), np.random.default_rng(1))
    win = loop.run(0.02)
    loop.drain()
    sweeps = [a.sweep for a in win.answers]
    assert sweeps == sorted(sweeps) and sweeps[0] == 0
    assert sweeps[-1] == win.pumps - 1
    sizes = np.bincount(sweeps)
    assert sizes.max() <= min(clients, width) and sizes.sum() == win.answered
