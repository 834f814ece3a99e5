"""Port parity: the Python API (``bonsai_tpu_torch/api.py``: ``get_kmers``,
``seqdict``, ``rolling_hashes``) against ``bonsai_tpu.api``.

Inputs: ``tests/data/phix.fa``, ``small_genome.fa`` and a 100 kb slice of
the E. coli K-12 genome; the port runs with ``device="cpu"`` (the plain
torch versions of KB1, KB4 and KR1).  Tolerance: exact equality of the
returned uint64 arrays, order included.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from bonsai_tpu import api as japi
from bonsai_tpu.core.alphabet import InputType

from bonsai_tpu_torch import api

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PHIX = os.path.join(DATA, "phix.fa")
SMALL = os.path.join(DATA, "small_genome.fa")
K12 = os.path.join(DATA, "ec", "GCF_000005845.2_ASM584v2_genomic.fna.gz")


@pytest.fixture(scope="module")
def k12():
    """100 kb of the K-12 genome from 1 Mb in, an N run placed in it."""
    with gzip.open(K12, "rb") as fh:
        seq = b"".join(line.strip() for line in fh
                       if not line.startswith(b">"))
    s = bytearray(seq[1_000_000:1_100_000])
    s[5000:5040] = b"N" * 40
    return bytes(s)


def _same(a, b):
    assert a.dtype == b.dtype == np.uint64
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(k=31), dict(k=31, canonicalize=False), dict(k=31, w=40),
    dict(k=31, w=40, scheme="entropy"),
    dict(k=31, w=40, scheme="entropy", canonicalize=False),
    dict(k=13, w=29, scheme="entropy"),
    dict(k=21, spacing="0x16,1x4", w=40, scheme="entropy"),
    dict(k=21, w=31, unique=True), dict(k=25, w=37, scheme="entropy-file"),
], ids=lambda kw: ",".join(f"{a}={b}" for a, b in kw.items()))
def test_get_kmers_matches_jax(k12, kw):
    _same(api.get_kmers(k12, device="cpu", **kw), japi.get_kmers(k12, **kw))


@pytest.mark.parametrize("it,k,w,spacing,scheme", [
    (InputType.PROTEIN20, 7, 7, "", "lex"),
    (InputType.PROTEIN20, 7, 20, "", "entropy"),
    (InputType.PROTEIN_14, 10, 24, "", "lex"),
    (InputType.PROTEIN_6, 12, 30, "1x11", "entropy"),
    (InputType.PROTEIN, 8, 8, "", "lex"),
    (InputType.PROTEIN_3BIT, 22, 22, "", "lex"),
], ids=lambda v: str(v))
def test_get_kmers_protein_matches_jax(k12, it, k, w, spacing, scheme):
    """The reading frame 0 of the K-12 slice, one letter a codon (stops as
    '*'), as protein of each alphabet."""
    prot = bytes(b"ACDEFGHIKLMNPQRSTVWY*"[sum(k12[i:i + 3]) % 21]
                 for i in range(0, 30_000, 3))
    kw = dict(k=k, w=w, spacing=spacing, input_type=it, scheme=scheme)
    _same(api.get_kmers(prot, device="cpu", **kw), japi.get_kmers(prot, **kw))


@pytest.mark.parametrize("path", [PHIX, SMALL])
@pytest.mark.parametrize("kw", [dict(k=31), dict(k=21, w=31, unique=True),
                                dict(k=13, spacing="1x12", w=40)])
def test_seqdict_matches_jax(path, kw):
    got = api.seqdict(path, device="cpu", **kw)
    want = japi.seqdict(path, **kw)
    assert list(got) == list(want)
    for name in want:
        _same(got[name], want[name])


@pytest.mark.parametrize("k,canon", [(7, False), (31, True), (64, True),
                                     (200, False)])
def test_rolling_hashes_matches_jax(k12, k, canon):
    _same(api.rolling_hashes(k12[:20_000], k, canon, device="cpu"),
          japi.rolling_hashes(k12[:20_000], k, canon))
    _same(api.rolling_hashes(b"ACGT", k, device="cpu"),
          japi.rolling_hashes(b"ACGT", k))


def test_default_device_is_the_card(monkeypatch):
    """With no card the default device raises; it never runs on the CPU
    instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: api.get_kmers(b"ACGTACGTAC", k=5),
                 lambda: api.seqdict(PHIX, k=31),
                 lambda: api.rolling_hashes(b"ACGTACGTAC", 5)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
