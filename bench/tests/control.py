"""The control of ``correct``: the plain reference computed in bfloat16
(``reference.precision.bfloat16``) put in the program's place. Run on the
card at a cell's own size, it has to come out not correct:

    python3 -m bench.tests.control --workload <cell> --seeds <n> <n> <n> [--seconds 5]

prints one JSON line a seed with the numbers compared and their limits.
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys

from bench import manifest
from bench.reference import precision


def bf16_answers(kind, A, traffic, starts):
    """The reference's answers for ``starts``, in bfloat16."""
    return kind.reference(A, traffic, starts, precision.bfloat16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(manifest.ROOT / "src"))
    from bench import run
    cell = manifest.cell(manifest.load(), args.workload)
    for seed in args.seeds:
        out = run.run_cell(cell, seed, args.seconds, False,
                           control=bf16_answers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
