"""The paper's own workload config: Graph500 scale 21 (the analog of the
paper's 2.4M-vertex / 67M-edge dataset) as a padded degree-64 ELL, k-hop
over 256 concurrent queries. Port of ``repro.configs.graph500``; read by
``launch.dryrun``'s graph cells and by ``chip_smoke.py``, which runs it
on R-MAT data."""

GRAPH_CONFIG = dict(
    name="graph500_s21",
    n_vertices=2_097_152,      # scale 21
    max_deg=64,                # padded ELL degree (edge factor 16, bucketed)
    queries=256,               # concurrent k-hop queries (threadpool width)
    k=2,
    formats=("khop", "khop_bitmap", "khop_bitmap_sentinel"),
)
