"""PyTorch port of the GraphBLAS graph engine (``repro``), for NVIDIA Hopper.

Same subpackage layout as the JAX package: ``core`` (storage, semirings,
bitmap words, the ``grb`` op surface), ``kernels`` (hand-written CUDA C++
for ``sm_90a``, built at first use), ``graph`` (builder and generators),
``query`` (parser, planner, executor, reference oracle) and ``engine``
(the continuous-batching ``QueryServer``).

Entry points place data on ``device="cuda"`` unless the caller passes
``device="cpu"``. CUDA tensors go through the kernels; CPU tensors take
each kernel's plain PyTorch version. This package never imports ``jax`` or
``repro``.
"""
