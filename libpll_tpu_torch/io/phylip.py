"""PHYLIP alignment reading (interleaved and sequential).

Capability parity with the reference parser (libpll `src/phylip.c:24-730`):
the header line gives ``taxa_count site_count``; sequential files list each
taxon's full sequence after its label, interleaved files cycle through taxa
in blocks. Produces an :class:`MSA` (reference pll_msa_t, pll.h:271-278).

Counterpart: ``libpll_tpu/io/phylip.py``, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..errors import PhylipError


@dataclass
class MSA:
    """reference pll_msa_t."""

    count: int
    length: int
    labels: List[str]
    sequences: List[str]


def _parse_header(line: str):
    parts = line.split()
    if len(parts) != 2:
        raise PhylipError("Invalid PHYLIP header: expected 'taxa sites'")
    try:
        return int(parts[0]), int(parts[1])
    except ValueError as e:
        raise PhylipError("Invalid PHYLIP header numbers") from e


def _clean(seq: str) -> str:
    return "".join(seq.split())


def parse_phylip_sequential(path: str) -> MSA:
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    lines = [ln for ln in lines if ln.strip()]
    if not lines:
        raise PhylipError(f"empty PHYLIP file {path}")
    count, length = _parse_header(lines[0])
    labels, seqs = [], []
    i = 1
    for _ in range(count):
        if i >= len(lines):
            raise PhylipError("unexpected end of PHYLIP file")
        parts = lines[i].split(None, 1)
        label = parts[0]
        seq = _clean(parts[1]) if len(parts) > 1 else ""
        i += 1
        while len(seq) < length:
            if i >= len(lines):
                raise PhylipError(
                    f"sequence for taxon {label!r} shorter than {length}")
            seq += _clean(lines[i])
            i += 1
        if len(seq) != length:
            raise PhylipError(
                f"sequence for taxon {label!r} has length {len(seq)}, "
                f"expected {length}")
        labels.append(label)
        seqs.append(seq)
    return MSA(count, length, labels, seqs)


def parse_phylip_interleaved(path: str) -> MSA:
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    # blocks are separated by blank lines; first block carries labels
    if not lines or not lines[0].strip():
        raise PhylipError(f"empty PHYLIP file {path}")
    count, length = _parse_header(lines[0])
    labels: List[str] = []
    seqs: List[str] = [""] * count
    idx = 0
    first_block = True
    for line in lines[1:]:
        if not line.strip():
            if idx not in (0, count):
                raise PhylipError("incomplete interleaved block")
            idx = 0
            first_block = first_block and not labels
            continue
        if len(labels) < count and first_block:
            parts = line.split(None, 1)
            labels.append(parts[0])
            seqs[idx] = _clean(parts[1]) if len(parts) > 1 else ""
        else:
            first_block = False
            seqs[idx % count] += _clean(line)
        idx += 1
    for lab, seq in zip(labels, seqs):
        if len(seq) != length:
            raise PhylipError(
                f"sequence for taxon {lab!r} has length {len(seq)}, "
                f"expected {length}")
    if len(labels) != count:
        raise PhylipError("fewer taxa than declared in header")
    return MSA(count, length, labels, seqs)
