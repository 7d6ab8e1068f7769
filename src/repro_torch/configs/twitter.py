"""The paper's large dataset: the Twitter graph (41.6M vertices / 1.47B
edges) as a distributed degree-64 ELL cell. Port of
``repro.configs.twitter``. The graph's edges are not in the repository,
so ``launch.dryrun`` accounts its layout only."""

GRAPH_CONFIG = dict(
    name="twitter41m",
    n_vertices=41_600_000,
    max_deg=64,                # degree-bucketed ELL stand-in
    queries=256,
    k=2,
    formats=("khop", "khop_bitmap", "khop_bitmap_sentinel"),
)
