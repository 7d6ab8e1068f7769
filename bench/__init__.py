"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and prints one
JSON line. Everything that decides a number lives here and imports neither
JAX nor the JAX package: the R-MAT generator (``data``), the card's
data-sheet rates (``peaks``), the client loop (``load``), the spans and the
trace reading (``trace``), the work a query needs (``work``), the plain
references (``reference/``) and the checks that decide ``correct``
(``checks``). Configurations, traffic mixes and per-layer metrics are files
under ``configs/``, ``traffic/`` and ``metrics/``, found by name.
"""
