"""Launch helpers: the production meshes (``launch.mesh``) and the graph
dry-run (``launch.dryrun``). Port of the graph half of
``repro.launch``."""
