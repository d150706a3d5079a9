"""The port's alignment input (``libpll_tpu_torch/io/fasta.py``,
``io/compress.py``) and amino-acid tables (``models/aa_tables.py``)
against the JAX package's on the same files and arrays: the tables array
for array, the FASTA records (headers, sequences, stripped counts, errors)
and the compressed patterns and weights exactly.
"""

import numpy as np
import pytest

from libpll_tpu.io import compress as jcompress
from libpll_tpu.io import fasta as jfasta
from libpll_tpu.io import maps as jmaps
from libpll_tpu.models import aa_tables as jtables

from libpll_tpu_torch.errors import EinvalError, FastaError, FileError
from libpll_tpu_torch.io import compress as tcompress
from libpll_tpu_torch.io import fasta as tfasta
from libpll_tpu_torch.io import maps as tmaps
from libpll_tpu_torch.models import aa_tables as ttables


@pytest.mark.parametrize("name", ["AA_MODELS", "AA_MIXTURE_MODELS"])
def test_aa_tables_equal_jax(name):
    """Every model's rates and frequencies, bit for bit."""
    want, got = getattr(jtables, name), getattr(ttables, name)
    assert sorted(got) == sorted(want)
    for model in want:
        for g, w in zip(got[model], want[model]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w), model


def _alignment(rng, taxa, sites, alphabet, odd):
    """Random rows over ``alphabet`` with ~5% of the cells from ``odd``
    (ambiguity codes and gaps) and a few duplicated columns."""
    rows = np.frombuffer(alphabet.encode(), np.uint8)[
        rng.integers(0, len(alphabet), (taxa, sites))]
    cells = rng.random(rows.shape) < 0.05
    rows[cells] = np.frombuffer(odd.encode(), np.uint8)[
        rng.integers(0, len(odd), int(cells.sum()))]
    rows[:, sites // 2:sites // 2 + 8] = rows[:, :8]  # repeated patterns
    return [r.tobytes().decode() for r in rows]


def _write(path, headers, seqs, width, noise=""):
    with open(path, "w") as fh:
        for h, s in zip(headers, seqs):
            fh.write(f">{h}\n\n")
            for i in range(0, len(s), width):
                fh.write(s[i:i + width] + noise + "\n")


@pytest.mark.parametrize("alphabet,odd,charmap", [
    (tmaps.AA_STATES, "-XBZ?*", "pll_map_aa"),
    (tmaps.NT_STATES, "-NRYWSKM", "pll_map_nt")])
def test_fasta_and_compress_equal_jax(tmp_path, alphabet, odd, charmap):
    """Records (streamed and whole), file positions, patterns, their
    order and weights, and the encoded masks, on a file with ambiguity
    codes, gaps, blank lines, lower case and characters the reader strips
    ('j' with a count, tabs silently)."""
    rng = np.random.default_rng(len(alphabet))
    headers = [f"taxon_{i} some description" for i in range(9)]
    seqs = _alignment(rng, 9, 500, alphabet, odd)
    seqs[3] = seqs[3].lower()
    path = str(tmp_path / "aln.fasta")
    _write(path, headers, seqs, 61, noise="j\t")

    want = jfasta.FastaReader(path)
    got = tfasta.FastaReader(path)
    assert got.getfilesize() == want.getfilesize()
    while True:
        w, g = want.getnext(), got.getnext()
        assert (g is None) == (w is None)
        assert got.getfilepos() == want.getfilepos()
        if w is None:
            break
        assert (g.header, g.sequence, g.stripped, g.seqno) == (
            w.header, w.sequence, w.stripped, w.seqno)
    assert [r.stripped for r in tfasta.FastaReader(path)] == [9] * 9
    got_h, got_s = tfasta.parse_fasta(path)
    assert (got_h, got_s) == jfasta.parse_fasta(path)
    assert got_h == headers

    tmap, jmap = getattr(tmaps, charmap), getattr(jmaps, charmap)
    want_p, want_w = jcompress.compress_site_patterns(got_s, jmap)
    got_p, got_w = tcompress.compress_site_patterns(got_s, tmap)
    assert got_p == want_p
    assert got_w.dtype == np.int64 and np.array_equal(got_w, want_w)
    assert got_w.sum() == 500 and len(got_p[0]) < 500
    masks = tmap[np.frombuffer("".join(got_p).encode(), np.uint8)]
    want_masks = jmap[np.frombuffer("".join(want_p).encode(), np.uint8)]
    assert np.array_equal(masks, want_masks)
    assert np.array_equal(tmap, jmap)


def test_fasta_and_compress_errors(tmp_path):
    """The same errors as the JAX package's: no header, data before the
    first header, a fatal character, a missing file; unequal rows and an
    illegal character in compression."""
    cases = {"noheader.fasta": "ACGT\nACGT\n",
             "early.fasta": "ACGT\n>a\nACGT\n",
             "fatal.fasta": ">a\nAC.GT\n"}
    for name, text in cases.items():
        path = tmp_path / name
        path.write_text(text)
        for reader in (jfasta, tfasta):
            with pytest.raises(Exception) as info:
                reader.parse_fasta(str(path))
            assert type(info.value).__name__ == "FastaError", name
        with pytest.raises(FastaError):
            tfasta.parse_fasta(str(path))
    with pytest.raises(FileError):
        tfasta.FastaReader(str(tmp_path / "missing.fasta"))
    with pytest.raises(EinvalError):
        tcompress.compress_site_patterns(["ACGT", "ACG"], tmaps.pll_map_nt)
    with pytest.raises(EinvalError):
        tcompress.compress_site_patterns(["ACGT", "ACJT"], tmaps.pll_map_nt)
    with pytest.raises(EinvalError):
        tcompress.compress_site_patterns([], tmaps.pll_map_nt)
