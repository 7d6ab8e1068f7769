"""The device mesh (``distr.mesh``) and the op lowerings over it
(``distr.graph2d``): port of ``repro.distr``'s op half."""
