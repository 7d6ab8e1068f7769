"""The device mesh (``distr.mesh``), the op lowerings over it
(``distr.graph2d``) and int8 gradient compression (``distr.compression``):
port of ``repro.distr``'s op half."""
