"""The paper's two graph workload configs (``graph500``, ``twitter``):
port of the graph half of ``repro.configs``. Each module holds one
``GRAPH_CONFIG`` dict, read by ``launch.dryrun`` and ``chip_smoke.py``."""
