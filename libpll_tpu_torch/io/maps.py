"""Character-to-state-bitmask maps.

Capability parity with the reference's map tables (libpll `src/maps.c:24-143`,
declared `src/pll.h:474-478`): each map is a 256-entry uint32 array indexed by
ASCII code, whose value is a bitmask over model states (bit *i* set means the
character is compatible with state *i*); 0 means "illegal character". Gaps and
unknowns map to the all-ones mask. The tables here are constructed
symbolically but are value-identical to the reference (verified against the
compiled oracle in tests).

State orders:
  * nucleotides: A C G T   (bit 0 = A ... bit 3 = T)
  * amino acids: A R N D C Q E G H I L K M F P S T W Y V (bits 0..19)

Counterpart: ``libpll_tpu/io/maps.py`` (copied; the tables are numpy).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pll_map_bin",
    "pll_map_nt",
    "pll_map_aa",
    "pll_map_fasta",
    "pll_map_phylip",
    "NT_STATES",
    "AA_STATES",
]

NT_STATES = "ACGT"
AA_STATES = "ARNDCQEGHILKMFPSTWYV"


def _build_map(definitions: dict[str, int]) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for chars, mask in definitions.items():
        for ch in chars:
            table[ord(ch)] = mask
            if ch.isalpha():
                table[ord(ch.swapcase())] = mask
    return table


def _mask(states: str, chars: str) -> int:
    m = 0
    for ch in chars:
        m |= 1 << states.index(ch)
    return m


# --- binary (2-state) data: 0 -> state 0, 1 -> state 1, -/? -> gap ---------
pll_map_bin = _build_map({"0": 1, "1": 2, "-?": 3})

# --- nucleotides with full IUPAC ambiguity codes ---------------------------
_NT_GAP = 0b1111
pll_map_nt = _build_map(
    {
        "a": _mask(NT_STATES, "A"),
        "c": _mask(NT_STATES, "C"),
        "g": _mask(NT_STATES, "G"),
        "tu": _mask(NT_STATES, "T"),
        "r": _mask(NT_STATES, "AG"),
        "y": _mask(NT_STATES, "CT"),
        "s": _mask(NT_STATES, "CG"),
        "w": _mask(NT_STATES, "AT"),
        "k": _mask(NT_STATES, "GT"),
        "m": _mask(NT_STATES, "AC"),
        "b": _mask(NT_STATES, "CGT"),
        "d": _mask(NT_STATES, "AGT"),
        "h": _mask(NT_STATES, "ACT"),
        "v": _mask(NT_STATES, "ACG"),
        "nxo-?": _NT_GAP,
    }
)

# --- amino acids with B/Z ambiguities ---------------------------------------
_AA_GAP = (1 << 20) - 1  # 0xfffff
pll_map_aa = _build_map(
    dict(
        {aa.lower(): 1 << i for i, aa in enumerate(AA_STATES)},
        b=_mask(AA_STATES, "ND"),
        z=_mask(AA_STATES, "QE"),
    )
    | {"x*-?": _AA_GAP}
)


# --- parser validity maps ----------------------------------------------------
# Classification used by the FASTA/PHYLIP readers (maps.c comment block):
#   0 = stripped with a warning count, 1 = legal, 2 = fatal, 3 = silently
#   stripped whitespace.
def _build_validity_map() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    table[0:32] = 2  # control chars fatal ...
    table[9:14] = 3  # ... except tab/lf/vt/ff/cr: silently stripped
    table[ord(".")] = 2  # period is fatal
    for ch in "?*-0123456789":
        table[ord(ch)] = 1
    for ch in "abcdefghijklmnopqrstuvwxyz":
        if ch == "j":
            continue  # 'j' is stripped in the reference fasta/phylip maps
        table[ord(ch)] = 1
        table[ord(ch.upper())] = 1
    return table


pll_map_fasta = _build_validity_map()
pll_map_phylip = _build_validity_map()


def encode_sequence(sequence: str, charmap: np.ndarray) -> np.ndarray:
    """Encode an ASCII sequence into per-site state bitmasks.

    Mirrors the validation loop of `set_tipclv` (libpll `src/pll.c:905-936`):
    raises on any character whose map entry is 0.
    """
    from ..errors import TipDataError

    codes = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
    masks = np.asarray(charmap)[codes]
    if np.any(masks == 0):
        bad = sequence[int(np.argmax(masks == 0))]
        raise TipDataError(f'Illegal state code in tip "{bad}"')
    return masks.astype(np.uint32)


def tipmask_to_clv(masks: np.ndarray, states: int) -> np.ndarray:
    """Expand per-site bitmasks into 0/1 conditional likelihoods [sites, states].

    The bit-decomposition step of `set_tipclv` (libpll `src/pll.c:925-931`).
    """
    bits = (masks[:, None] >> np.arange(states, dtype=np.uint32)[None, :]) & 1
    return bits.astype(np.float64)
