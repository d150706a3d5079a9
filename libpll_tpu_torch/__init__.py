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
* the roofline probes K7/K8 (``ops.roofline``);
* the stateful ``Partition`` API (``engine.partition``; libpll's
  step-by-step surface, its buffers on the card unless built with
  ``device="cpu"``) and ``engine.evaluate.model_from_partition``, which
  hands a Partition's parameters to the factories above; the tree and I/O
  host layer (``tree.utree``, ``tree.rtree``, ``tree.moves``,
  ``tree.incremental``, ``tree.compare``, ``tree.svg``, ``tree.schedule``,
  ``io.phylip``, ``io.fasta``, ``io.compress``), checkpoints
  (``engine.checkpoint``), the debug printers (``utils.output``) and the
  run log (``utils.logging``);
* parsimony (``search.parsimony``: bit-packed Fitch ``FastParsimony`` on
  the popcount kernels P1 and P2 of ``ops.fitch``, weighted Sankoff
  ``Parsimony`` in plain PyTorch, ``ops.sankoff``) and randomized stepwise
  addition (``search.stepwise.fastparsimony_stepwise``: the host engine
  on P1 and P2, the device engine on P2 and P3 with no host read inside
  the insertion loop; ``utils.rng``, glibc's ``random_r``, stream-exact).
  Both engines give ``libpll_tpu``'s score and tree for every seed.

On the CPU, ``python -m pytest tests/test_torch_parsimony.py
tests/test_torch_stepwise.py`` holds the parsimony layer to
``libpll_tpu``'s exactly (about 40 s); on an H100, ``python3
chip_smoke.py``'s phases 24-26 hold P1-P3 to their plain versions at
every launch, build the stepwise trees of scripts/bench_stepwise.py's
2 048 x 2 048 and 500 x 10 000 alignments by both engines, each equal to
the JAX package's, and time the builds and kernels (PERF.md).

The top-level names are ``libpll_tpu``'s, less ``optimize_model``: model
fitting is not ported yet, nor are tree search and multi-GPU sharding.
"""

from .engine.partition import (ASC_FELSENSTEIN, ASC_LEWIS, ASC_NONE,
                               ASC_STAMATAKIS, Operation, Partition)
from .errors import PllError
from .io import maps
from .models.gamma import compute_gamma_cats
from .utils.constants import (GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN,
                              SCALE_BUFFER_NONE)

__version__ = "0.1.0"
