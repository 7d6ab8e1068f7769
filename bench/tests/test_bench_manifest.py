"""BENCHMARK.json against the contract's rules, and the harness finding
configurations, traffic mixes and metrics by name: a new cell or metric is
new files and new entries only."""
import json
import shutil

import pytest

from bench import manifest
from bench.tests import helpers


def test_manifest_names_units_and_files_are_sound():
    m = manifest.load()
    assert manifest.problems(m) == []
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"]
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for w in m["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        c = manifest.cell(m, w["name"])
        assert any(e["name"] != "setup_s" for e in c.end_to_end)
        assert c.per_layer, w["name"]
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in e["layer"] and len(e["layer"]) <= 200


@pytest.mark.parametrize("bad", ["a b", "x/y", "", "é", "a" * 65, ".x"])
def test_bad_names_are_refused(bad):
    m = manifest.load()
    m["end_to_end"][0] = dict(m["end_to_end"][0], name=bad)
    assert manifest.problems(m)


@pytest.mark.parametrize("unit", ["tokens per second", "µs", ""])
def test_bad_units_are_refused(unit):
    m = manifest.load()
    m["per_layer"][0] = dict(m["per_layer"][0], unit=unit)
    assert manifest.problems(m)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = manifest.cell(manifest.load(), cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["answer"] in __import__("bench.checks").checks.KINDS
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"]).read)


def test_a_cell_and_a_metric_added_as_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    per-layer metric as new files plus new entries, and runs the new cell
    with no file that was there edited."""
    root = tmp_path / "checkout"
    bench = root / "bench"
    shutil.copytree(manifest.BENCH, bench,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    m = manifest.load()
    cfg = dict(manifest.cell(m, "khop2-graph500-s16").config,
               name="dummy-s9", scale=9)
    (bench / "configs" / "dummy-s9.json").write_text(json.dumps(cfg))
    traffic = dict(json.loads((bench / "traffic" / "khop2.json")
                              .read_text()), clients=64)
    traffic["query"] = traffic["query"].replace("*1..2", "*1..3")
    traffic["hops"] = 3
    (bench / "traffic" / "khop3small.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "answered.dummy.py").write_text(
        "def read(r):\n    return r.window.answered\n")
    m["configs"].append({"name": "dummy-s9", "source": "https://example.org",
                         "file": "bench/configs/dummy-s9.json",
                         "reduced": ["scale"], "why": "a dummy"})
    m["workloads"].append({"name": "khop3-dummy", "config": "dummy-s9",
                           "traffic": "khop3small", "chips": 1,
                           "why": "a dummy"})
    for e in m["end_to_end"]:
        if e["name"] == "khop_qps":
            e["workloads"].append("khop3-dummy")
    m["per_layer"].append({"name": "answered.dummy", "unit": "queries",
                           "better": "higher", "source": "host_clock",
                           "layer": "server", "moves": "khop_qps",
                           "workloads": ["khop3-dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.problems(m, bench) == []
    c = manifest.cell(m, "khop3-dummy", bench)
    assert c.config["scale"] == 9 and c.traffic["hops"] == 3

    from bench import run
    out = run.run_cell(c, 77, 0.2, True, device="cpu")
    assert out["correct"] is True
    assert out["metrics"]["answered.dummy"]["value"] == out["attempted"]
    out = run.run_cell(c, 78, 0.2, False, device="cpu")
    assert set(out["metrics"]) == {"khop_qps", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_result_keys_and_checks_come_last():
    out = helpers.run_small("tc-graphchallenge-s15", scale=8)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"algo_call_ms", "setup_s"}
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
