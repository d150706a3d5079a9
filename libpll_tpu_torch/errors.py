"""Error taxonomy.

The reference library signals failures through a thread-local errno plus a
200-char message (libpll `src/pll.h:135-167`, `src/pll.c:24-25`). Here every
fallible operation raises a typed exception instead; the class hierarchy
mirrors the reference error-code families so callers can catch at the same
granularity the C error codes allowed.

Counterpart: ``libpll_tpu/errors.py``, copied rather than imported because
importing any ``libpll_tpu`` module loads jax.
"""

from __future__ import annotations


class PllError(Exception):
    """Base class for all engine errors."""


class FileError(PllError):
    """File open / seek / EOF errors (reference: PLL_ERROR_FILE_*)."""


class FileEOFError(FileError):
    """End of file reached (reference: PLL_ERROR_FILE_EOF)."""


class FastaError(FileError):
    """FASTA parsing errors (reference: PLL_ERROR_FASTA_*)."""


class PhylipError(FileError):
    """PHYLIP parsing errors (reference: PLL_ERROR_PHYLIP_*)."""


class NewickError(PllError):
    """Newick syntax errors (reference: PLL_ERROR_NEWICK_SYNTAX)."""


class MemError(PllError):
    """Allocation failures (reference: PLL_ERROR_MEM_ALLOC)."""


class ParamError(PllError, ValueError):
    """Invalid parameter values (reference: PLL_ERROR_PARAM_INVALID)."""


class TipDataError(PllError):
    """Illegal tip state / illegal function for tip encoding
    (reference: PLL_ERROR_TIPDATA_*)."""


class TreeError(PllError):
    """Tree conversion / traversal size errors
    (reference: PLL_ERROR_TREE_*)."""


class SprError(TreeError):
    """Invalid SPR/NNI moves (reference: PLL_ERROR_SPR_*, PLL_ERROR_NNI_*)."""


class InvarError(ParamError):
    """Invariant-site proportion errors (reference: PLL_ERROR_INVAR_*)."""


class AscBiasError(ParamError):
    """Ascertainment-bias configuration errors (reference: PLL_ERROR_AB_*)."""


class EinvalError(PllError, ValueError):
    """Invalid argument (reference: PLL_ERROR_EINVAL)."""


class KernelError(PllError, RuntimeError):
    """A CUDA kernel of the port failed to build or to launch.  (No
    reference counterpart: the C library has no device kernels.)"""


class CapacityError(PllError, ValueError):
    """A schedule-as-data envelope overflowed: an op subset is larger than
    the fixed capacity a compiled executor was built for.  Drivers catch
    exactly this to resize the envelope; any other failure propagates.
    (No reference counterpart — the C library has no compiled-shape
    envelopes; subclasses ValueError for backward compatibility.)"""
