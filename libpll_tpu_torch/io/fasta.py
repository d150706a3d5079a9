"""FASTA reading.

Capability parity with the reference's streaming FASTA reader (libpll
`src/fasta.c:24-324`): header lines start with '>', sequence characters are
classified by a validity map (legal / silently-stripped whitespace /
stripped-with-count / fatal), and iteration yields
``(header, sequence, stripped_count, sequence_number)``.

Counterpart: ``libpll_tpu/io/fasta.py`` (``FastaReader``, ``parse_fasta``
``:151``).  The same records and errors; a record's lines are classified
with one numpy lookup instead of a character loop (or the JAX package's
native scanner), which keeps an alignment of millions of columns quick.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from ..errors import FastaError, FileError
from .maps import pll_map_fasta

# validity classes of pll_map_fasta (maps.c): strip and count, keep, fatal
_STRIP, _KEEP, _FATAL = 0, 1, 2


@dataclass
class FastaRecord:
    header: str
    sequence: str
    stripped: int
    seqno: int


class FastaReader:
    """Streaming FASTA reader (reference `pll_fasta_open/getnext/rewind/
    getfilesize/getfilepos/close`, src/pll.h:666-681): records are consumed
    one at a time with :meth:`getnext` (None at end of file — the
    counterpart of the reference's ``pll_errno == PLL_ERROR_FILE_EOF``
    convention), :meth:`rewind` restarts the stream, and
    :meth:`getfilepos` / :meth:`getfilesize` report byte progress through
    the file."""

    def __init__(self, path: str, charmap: np.ndarray | None = None):
        self.path = path
        self.map = np.asarray(charmap if charmap is not None else
                              pll_map_fasta)
        try:
            with open(path, "rb") as fh:
                self._data = fh.read()
        except OSError as e:
            raise FileError(f"Unable to open file ({path})") from e
        text = self._data.decode("latin-1")
        # line start offsets (byte == char offsets in latin-1)
        self._lines: List[str] = []
        self._offsets: List[int] = []
        pos = 0
        for line in text.splitlines(keepends=True):
            self._lines.append(line.rstrip("\r\n"))
            self._offsets.append(pos)
            pos += len(line)
        self._offsets.append(len(text))  # EOF sentinel
        if not any(ln.startswith(">") for ln in self._lines if ln.strip()):
            raise FastaError(f"Invalid FASTA format in {path}")
        self._cursor = 0
        self._seqno = 0
        self._closed = False

    def getnext(self) -> "FastaRecord | None":
        """Next record, or None at end of file."""
        if self._closed:
            raise FileError("FASTA reader is closed")
        n = len(self._lines)
        # skip blanks up to the next header
        while self._cursor < n and not self._lines[self._cursor].strip():
            self._cursor += 1
        if self._cursor >= n:
            return None
        line = self._lines[self._cursor]
        if not line.startswith(">"):
            raise FastaError("sequence data before first header")
        header = line[1:].strip()
        self._cursor += 1
        start = self._cursor
        while self._cursor < n and not self._lines[self._cursor].startswith(">"):
            self._cursor += 1
        sequence, stripped = _filter_sequence(
            "".join(self._lines[start:self._cursor]), self.map)
        rec = FastaRecord(header, sequence, stripped, self._seqno)
        self._seqno += 1
        return rec

    def rewind(self) -> None:
        """Restart the stream (reference `pll_fasta_rewind`)."""
        self._cursor = 0
        self._seqno = 0

    def getfilesize(self) -> int:
        """Total file size in bytes (reference `pll_fasta_getfilesize`)."""
        return len(self._data)

    def getfilepos(self) -> int:
        """Byte offset of the read cursor (reference
        `pll_fasta_getfilepos`)."""
        return self._offsets[self._cursor]

    def close(self) -> None:
        """Release the buffer (reference `pll_fasta_close`)."""
        self._closed = True
        self._data = b""

    def __iter__(self) -> Iterator[FastaRecord]:
        self.rewind()
        while (rec := self.getnext()) is not None:
            yield rec

    def read_all(self) -> Tuple[List[str], List[str]]:
        """Return (headers, sequences)."""
        headers, seqs = [], []
        for rec in self:
            headers.append(rec.header)
            seqs.append(rec.sequence)
        return headers, seqs


def _filter_sequence(text: str, charmap: np.ndarray) -> Tuple[str, int]:
    """A record's sequence lines, joined: (the legal characters, the count
    of stripped ones); a fatal character raises."""
    raw = np.frombuffer(text.encode("latin-1"), dtype=np.uint8)
    cls = np.asarray(charmap)[raw]
    fatal = np.flatnonzero(cls == _FATAL)
    if fatal.size:
        ch = chr(raw[fatal[0]])
        raise FastaError(f"Illegal character ({ch!r}) in FASTA sequence")
    kept = raw[cls == _KEEP]
    return kept.tobytes().decode("latin-1"), int((cls == _STRIP).sum())


def parse_fasta(path: str) -> Tuple[List[str], List[str]]:
    """Convenience: (headers, sequences) for a whole file."""
    return FastaReader(path).read_all()
