"""PyTorch port, the write path (``repro_torch.engine``): ``Database``,
``MutableGraph``, AOF and snapshot persistence, and the server's mutable
sources, held against the JAX package's ``repro.engine`` on the CPU.

The scripted CREATE / DELETE session answers row for row as the JAX
``Database`` does and as the port's own rebuild-on-freeze mode does, with
one base build (``rebuilds == 1``) and the same compaction count. A
reader frozen before a write batch never sees it. Each package replays
the other's AOF and loads the other's snapshot to the same rows. Every
command is fsynced before ``query`` returns.
"""
import os

import numpy as np
import pytest
import torch

from repro.engine import Database as JDatabase
from repro.engine import persistence as JP
from repro_torch.core import delta as tdelta
from repro_torch.engine import (Database, MutableGraph, QueryServer,
                                load_snapshot, save_snapshot)
from repro_torch.engine import persistence as TP
from repro_torch.graph.graph import GraphBuilder


def tdb(data_dir=None, delta=True):
    return Database(data_dir=data_dir, delta=delta, device="cpu")


def script(db, name: str = "g"):
    """One scripted CREATE / DELETE session with interleaved reads (the
    JAX delta suite's)."""
    db.query(name, "CREATE (:Person {id: 0, age: 30}), "
                   "(:Person {id: 1, age: 40}), (:Person {id: 2, age: 50}), "
                   "(:Person {id: 3, age: 60})")
    db.query(name, "CREATE (0)-[:KNOWS]->(1), (1)-[:KNOWS]->(2), "
                   "(2)-[:KNOWS]->(3), (3)-[:KNOWS]->(0)")
    db.query(name, "MATCH (a)-[:KNOWS]->(b) RETURN count(b)")  # a base
    db.query(name, "DELETE (1)-[:KNOWS]->(2)")
    db.query(name, "CREATE (1)-[:VISITS]->(3), (0)-[:KNOWS]->(2)")
    db.query(name, "CREATE (:Person {age: 70})")               # auto-id: 4
    db.query(name, "CREATE (4)-[:KNOWS]->(0)")
    db.query(name, "DELETE (3)")                               # tombstone


QUERIES = [
    "MATCH (a)-[:KNOWS*1..3]->(b) WHERE id(a) = 0 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS]->(b) RETURN a, b",
    "MATCH (a:Person)-[:KNOWS]->(b) WHERE b.age > 35 RETURN a, b",
    "MATCH (a)-[:VISITS]->(b) RETURN count(b)",
    "MATCH (a)<-[:KNOWS]-(b) WHERE id(a) = 0 RETURN count(DISTINCT b)",
]


def rows(db, name="g"):
    return [db.query(name, q).rows for q in QUERIES]


@pytest.fixture(scope="module")
def jax_rows():
    j = JDatabase()
    script(j)
    return rows(j), j._graph("g").rebuilds, j._graph("g").compactions


@pytest.mark.parametrize("fmt", ["auto", "bsr", "ell", "dense"])
def test_scripted_session_matches_jax(jax_rows, fmt):
    want, j_rebuilds, j_compactions = jax_rows
    live = tdb()
    live._graph("g").fmt = fmt
    script(live)
    assert rows(live) == want
    mg = live._graph("g")
    assert mg.rebuilds == 1 == j_rebuilds
    assert mg.compactions == j_compactions
    g = mg.freeze()
    assert g.relation("KNOWS").A.fmt == "delta"
    assert g.relation("KNOWS").A.store.fmt == ("ell" if fmt == "auto"
                                               else fmt)
    assert g.device == torch.device("cpu")


def test_delta_serving_equals_rebuild_on_freeze(jax_rows):
    live, oracle = tdb(), tdb(delta=False)
    script(live)
    script(oracle)
    assert rows(live) == rows(oracle) == jax_rows[0]
    assert live._graph("g").rebuilds == 1
    assert oracle._graph("g").rebuilds > 1


def test_zero_rebuilds_under_write_stream():
    db = tdb()
    mg = db._graph("g")
    db.query("g", "CREATE (:N {id: 0}), (:N {id: 1})")
    db.query("g", "CREATE (0)-[:R]->(1)")
    for i in range(2, 12):
        db.query("g", f"CREATE (:N {{id: {i}}})")
        db.query("g", f"CREATE ({i - 1})-[:R]->({i})")
        res = db.query("g", "MATCH (a)-[:R*1..3]->(b) WHERE id(a) = 0 "
                            "RETURN count(DISTINCT b)")
        assert res.scalar() == min(3, i)
    assert mg.rebuilds == 1


def test_compaction_triggers_and_stays_correct():
    db = tdb()
    mg = db._graph("g")
    db.query("g", "CREATE (:N {id: 0}), (:N {id: 1}), (:N {id: 2})")
    db.query("g", "CREATE (0)-[:R]->(1), (1)-[:R]->(2)")
    db.query("g", "MATCH (a)-[:R]->(b) RETURN count(b)")   # base: 2 entries
    for i in range(3, 20):
        db.query("g", f"CREATE (:N {{id: {i}}}), (0)-[:R]->({i})")
        db.query("g", "MATCH (a)-[:R]->(b) WHERE id(a) = 0 RETURN count(b)")
    assert mg.compactions > 0 and mg.rebuilds == 1
    assert db.query("g", "MATCH (a)-[:R]->(b) WHERE id(a) = 0 "
                         "RETURN count(b)").scalar() == 18
    g = mg.freeze()
    assert not tdelta.needs_compaction(g.relation("R").A.store)
    # only the freshest view per flavour is kept
    assert len(mg._views) == 1


def test_snapshot_isolation_reader_never_sees_writer_batch():
    db = tdb()
    db.query("g", "CREATE (:N {id: 0}), (:N {id: 1}), (:N {id: 2})")
    db.query("g", "CREATE (0)-[:R]->(1), (1)-[:R]->(2)")
    reader = db.context("g")
    q = "MATCH (a)-[:R*1..2]->(b) WHERE id(a) = 0 RETURN count(DISTINCT b)"
    before = reader.run(q).rows
    A0 = reader.graph.relation("R").A
    dense0 = A0.to_dense().clone()
    for i in range(3, 8):
        db.query("g", f"CREATE (:N {{id: {i}}}), ({i - 1})-[:R]->({i})")
        if i == 5:
            db.query("g", "DELETE (0)-[:R]->(1)")
        db.query("g", q)                       # the writer's side reads too
        assert reader.run(q).rows == before
    assert torch.equal(reader.graph.relation("R").A.to_dense(), dense0)
    after = db.query("g", q)
    assert after.rows != before and after.scalar() == 0


def test_server_sources():
    db = tdb()
    script(db)
    q = "MATCH (a)-[:KNOWS]->(b) WHERE id(a) = $s RETURN count(b)"
    want = [db.query("g", q.replace("$s", str(s))).rows for s in range(5)]
    for srv in (QueryServer(db._graph("g")), QueryServer(db, graph="g"),
                db.server("g")):
        ids = [srv.submit(q.replace("$s", str(s))) for s in range(5)]
        out = srv.flush()
        assert [out[i].rows for i in ids] == want
    with pytest.raises(TypeError, match="graph=<name>"):
        QueryServer(db)
    # a write between batches is visible to the next batch
    srv = db.server("g")
    db.query("g", "CREATE (4)-[:KNOWS]->(2)")
    qid = srv.submit("MATCH (a)-[:KNOWS]->(b) WHERE id(a) = 4 "
                     "RETURN count(b)")
    assert srv.flush()[qid].rows == [(2,)]


def test_mesh_raises_not_implemented():
    """mesh= is served now (tests/test_torch_shard.py); what is not a
    ``distr.mesh.Mesh`` is refused with the JAX package's TypeError, at
    the first relation a read resolves, through every entry point."""
    db = tdb()
    db.query("g", "CREATE (0)-[:R]->(1)")
    q = "MATCH (a)-[:R]->(b) RETURN a"
    for call in (lambda: db.query("g", q, mesh=object()),
                 lambda: db.context("g", mesh=object()).run(q)):
        with pytest.raises(TypeError, match="needs a repro_torch"):
            call()
    srv = db.server("g", mesh=object())
    qid = srv.submit(q)
    assert "needs a repro_torch" in srv.flush()[qid].error


def test_cuda_database_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (lambda: Database(), lambda: MutableGraph()):
        with pytest.raises(RuntimeError, match="is_available"):
            make()


def test_every_command_is_fsynced_before_it_returns(tmp_path, monkeypatch):
    synced = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd),
                                                 real(fd))[1])
    db = tdb(str(tmp_path))
    cmds = ["CREATE (:N {id: 0}), (:N {id: 1})", "CREATE (0)-[:R]->(1)",
            "DELETE (0)-[:R]->(1)", "CREATE (1)-[:R]->(0)"]
    for i, c in enumerate(cmds):
        db.query("g", c)
        assert len(synced) == i + 1              # durable before the ack
    db.query("g", "MATCH (a)-[:R]->(b) RETURN a, b")   # reads log nothing
    assert len(synced) == len(cmds)
    with open(TP.aof_path(str(tmp_path), "g")) as f:
        assert [ln.strip() for ln in f] == cmds


def test_aof_replay_converges(tmp_path):
    q = "MATCH (a)-[:R*1..4]->(b) WHERE id(a) = 0 RETURN count(DISTINCT b)"
    db = tdb(str(tmp_path))
    db.query("g", "CREATE (:N {id: 0}), (:N {id: 1}), (:N {id: 2}), "
                  "(:N {id: 3})")
    db.query("g", "CREATE (0)-[:R]->(1), (1)-[:R]->(2), (2)-[:R]->(3)")
    db.query("g", "DELETE (1)-[:R]->(2)")
    db.query("g", "CREATE (1)-[:R]->(3), (3)-[:R]->(2)")
    db.query("g", "CREATE (:N)")                  # auto-id: 4
    db.query("g", "CREATE (2)-[:R]->(4)")
    db.query("g", "DELETE (3)")
    live = db.query("g", q).rows
    nvals = db._graph("g").freeze().relation("R").A.nvals
    del db
    db2 = tdb(str(tmp_path))
    assert db2.query("g", q).rows == live
    assert db2._graph("g").freeze().relation("R").A.nvals == nvals
    assert db2._graph("g").rebuilds == 1          # replay coalesced
    assert db2._graph("g").next_id == 5


SESSION = [
    "CREATE (:Person {id: 0, age: 30}), (:Person {id: 1, age: 40}), "
    "(:Person {id: 2, age: 50})",
    "CREATE (0)-[:KNOWS]->(1), (1)-[:KNOWS]->(2), (2)-[:KNOWS]->(0)",
    "DELETE (2)-[:KNOWS]->(0)",
    "CREATE (:Person {age: 20}), (3)-[:KNOWS]->(0), (1)-[:VISITS]->(3)",
    "DELETE (1)",
    "CREATE (0)-[:KNOWS]->(3)",
]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_aof_files_cross_load(tmp_path, writer):
    """Each package replays the AOF the other wrote, to the same rows."""
    make_w = (lambda: JDatabase(data_dir=str(tmp_path))) if writer == "jax" \
        else (lambda: tdb(str(tmp_path)))
    make_r = (lambda: tdb(str(tmp_path))) if writer == "jax" \
        else (lambda: JDatabase(data_dir=str(tmp_path)))
    w = make_w()
    for c in SESSION:
        w.query("g", c)
    want = rows(w)
    del w
    r = make_r()
    assert rows(r) == want
    assert r._graph("g").next_id == 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_files_cross_load(tmp_path, writer):
    """A snapshot (taken mid-write-stream, so of a delta-served graph) that
    one package saved loads in the other to the same relations, labels,
    properties and rows."""
    jdb, pdb = JDatabase(), tdb()
    for i, c in enumerate(SESSION):
        jdb.query("g", c)
        pdb.query("g", c)
        if i:                                   # KNOWS exists from then on
            jdb.query("g", QUERIES[1])
            pdb.query("g", QUERIES[1])
    path = str(tmp_path / "g.rdb")
    if writer == "jax":
        JP.save_snapshot(jdb._graph("g").freeze(), path)
        g = load_snapshot(path, fmt="bsr", device="cpu")
        src = jdb
    else:
        save_snapshot(pdb._graph("g").freeze(), path)
        g = JP.load_snapshot(path, fmt="bsr")
        src = pdb
    live = src._graph("g").freeze()
    for name, rel in live.relations.items():
        for a, b in zip(rel.A.to_coo(), g.relations[name].A.to_coo()):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    for k in live.labels:
        assert np.array_equal(np.asarray(live.labels[k]) if writer == "jax"
                              else live.labels[k].numpy(),
                              np.asarray(g.labels[k]) if writer == "port"
                              else g.labels[k].numpy())
    again = tdb() if writer == "jax" else JDatabase()
    again.load_graph("g", g)
    assert rows(again)[1:4] == rows(src)[1:4]


def test_load_graph_serves_a_bulk_graph_as_is():
    db = tdb()
    g = GraphBuilder(4).add_edges("R", [0, 1], [1, 2]).build(fmt="ell",
                                                             device="cpu")
    db.load_graph("g", g)
    assert db._graph("g").freeze() is g
    assert db.query("g", "MATCH (a)-[:R]->(b) RETURN a, b").rows == \
        [(0, 1), (1, 2)]
    assert "Expand" in db.explain("g", "MATCH (a)-[:R]->(b) RETURN a, b") \
        or db.explain("g", "MATCH (a)-[:R]->(b) RETURN a, b")
