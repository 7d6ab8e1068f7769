"""Storage kinds (BSR, ELL, BitELL), semirings, bitmap words and the
``grb`` op surface — the port of ``repro.core`` for the kinds the k-hop
MATCH path reaches."""
