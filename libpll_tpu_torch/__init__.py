"""libpll_tpu_torch — the PyTorch/CUDA port of libpll_tpu.

A second package beside ``libpll_tpu`` (the JAX reference, which stays as
it is).  It imports torch and numpy and never jax: the host layer
(``tree``, ``models``, ``io``, ``errors``) is copied from the JAX package,
plain tensor code is PyTorch, and every Pallas TPU kernel on the ported path
is a CUDA kernel written by hand for Hopper (``csrc/``), built with nvcc at
first use into ``libpll_tpu_torch/_build/``.

Ported so far: one full-tree log-likelihood evaluation —
``engine.evaluate.make_score`` (fused edge-score kernel K1),
``make_forward_fused`` (fused sweep kernel K2), ``make_forward`` (the plain
float64 reference) and ``make_asc_tail``.
"""

__version__ = "0.1.0"
