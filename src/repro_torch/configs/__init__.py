"""Configs: port of ``repro.configs``.

``base`` holds ``ModelConfig``, the shape grid and ``get_config``; one
module per model arch holds its ``CONFIG`` (the same numbers and sources as
the JAX package). The paper's two graph workload configs (``graph500``,
``twitter``) each hold one ``GRAPH_CONFIG`` dict, read by
``launch.dryrun`` and ``chip_smoke.py``."""
