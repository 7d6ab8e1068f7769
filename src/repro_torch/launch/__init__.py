"""Launch helpers: the production meshes (``launch.mesh``), the graph
dry-run (``launch.dryrun``) and the serving entry point (``launch.serve``).
Port of ``repro.launch``."""
