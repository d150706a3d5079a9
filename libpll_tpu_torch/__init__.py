"""libpll_tpu_torch — the PyTorch/CUDA port of libpll_tpu.

A second package beside ``libpll_tpu`` (the JAX reference, which stays as
it is).  It imports torch and numpy and never jax: the host layer
(``tree``, ``models``, ``io``, ``errors``) is copied from the JAX package,
plain tensor code is PyTorch, and every Pallas TPU kernel on the ported path
is a CUDA kernel written by hand for Hopper (``csrc/``), built with nvcc at
first use into ``libpll_tpu_torch/_build/``.

Ported so far (``engine.evaluate``; every factory builds its module on
the card unless given ``device="cpu"``):

* one full-tree log-likelihood evaluation: ``make_score`` (the fused
  edge-score kernel K1), ``make_forward_fused`` (the fused sweep kernel
  K2), ``make_forward`` (the plain float64 reference) and
  ``make_asc_tail``;
* the large-tree tiers: ``make_score_unbounded`` (the dyn kernels K5/K6,
  ``ops.clv_dyn``) and ``ops.clv_seg.make_segmented_score/sweep`` (K3/K4);
* the training step: ``make_train_step_fused`` (K2) and
  ``make_train_step``, with the branch-length derivatives and the Newton
  solve (kernel N1) of ``ops.derivatives``;
* the roofline probes K7/K8 (``ops.roofline``).

Not yet ported: the stateful ``Partition`` API, tree search, parsimony,
model fitting and multi-GPU sharding.
"""

__version__ = "0.1.0"
