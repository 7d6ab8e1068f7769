"""The command's refusals, and what a run loads, in fresh processes."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench import manifest

ROOT = manifest.ROOT


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "bench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


ARGS = ["--workload", "tc-graphchallenge-s15", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def test_no_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is not reachable")
    p = _run(ARGS, ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copytree(manifest.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run(ARGS, tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_unknown_workload_exits_nonzero():
    p = _run(["--workload", "nope", "--seed", "1", "--seconds", "1"], ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_loads_no_jax_and_no_jax_package():
    """Everything a run imports, driven on the CPU in a fresh process
    (traced, so the profiler and every reader load too): no module whose
    top-level name is jax, jaxlib, flax or repro."""
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'src')\n"
        "from bench import manifest, run\n"
        "from bench.tests import helpers\n"
        "for w in manifest.load()['workloads']:\n"
        "    c = helpers.small_cell(w['name'], scale=8)\n"
        "    run.run_cell(c, 5, 0.2, True, device='cpu')\n"
        "print(json.dumps(run.loaded_forbidden()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    found, loaded = (json.loads(x) for x in p.stdout.splitlines()[-2:])
    assert found == []
    assert "repro_torch" in loaded and "bench" in loaded
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)


@pytest.mark.parametrize("modules,found", [
    (["repro_torch", "repro_torch.core.grb", "jaxtyping", "flaxen"], []),
    (["repro.core", "repro_torch"], ["repro"]),
    (["jax._src.api", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_forbidden_names_are_matched_whole(modules, found):
    from bench import run
    assert run.loaded_forbidden(modules) == found
