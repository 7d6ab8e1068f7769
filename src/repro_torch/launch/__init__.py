"""Launch helpers: the production meshes (``launch.mesh``), the graph
dry-run (``launch.dryrun``) and the serving and training entry points
(``launch.serve``, ``launch.train``). Port of ``repro.launch``."""
