"""The plain reference on a case worked by hand."""

import numpy as np
import torch

from benchmark import deploy, reference

from .conftest import pool_of


def _dep(canonical=False):
    # root 1 -> genus 2 -> strains 3 and 4
    a = deploy.Genome("A", 3, [np.frombuffer(b"ACGTAC", np.uint8)])
    b = deploy.Genome("B", 4, [np.frombuffer(b"CGTAAT", np.uint8)])
    return deploy.Deployment("hand", 3, canonical, [a, b],
                             {1: 0, 2: 1, 3: 2, 4: 2}, {}, [], "", "")


def test_lca_map_by_hand():
    keys, taxa = reference.lca_map(_dep(), "cpu")
    # AAT 3, ACG 6, CGT 27, GTA 44, TAA 48, TAC 49 (A0 C1 G2 T3, first
    # base highest); CGT and GTA are in both strains: their genus
    assert keys.tolist() == [3, 6, 27, 44, 48, 49]
    assert taxa.tolist() == [4, 3, 2, 2, 4, 3]
    _, first = reference.lca_map(_dep(), "cpu", control=True)
    assert first.tolist() == [4, 3, 3, 3, 4, 3]


def test_kmer_taxa_by_hand():
    q = np.array([6, 27, 48, 50], dtype=np.int64)
    assert reference.kmer_taxa(_dep(), q, "cpu").tolist() == [3, 2, 4, 0]


def test_canonical_kmers():
    codes = torch.tensor([0, 1, 2, -1, 3], dtype=torch.int8)
    km, ok = reference.kmers(codes, 3, True)
    # ACG 6 (its reverse complement CGT is 27); CG- and G-T hold an N
    assert km[0].item() == 6 and ok.tolist() == [True, False, False]
    km, _ = reference.kmers(torch.tensor([1, 2, 3], dtype=torch.int8), 3,
                            True)
    assert km.item() == 6  # CGT -> its reverse complement ACG


def test_kraken_line_by_hand():
    dep = _dep()
    pool = pool_of([np.frombuffer(b"ACGTAAN", np.uint8)])
    lines = reference.kraken_lines(dep, pool, np.array([0]), "cpu")
    # hits ACG 3, CGT 2, GTA 2, TAA 4; scores 3 -> 3, 2 -> 2, 4 -> 3: the
    # tie of 3 and 4 resolves to their LCA 2; AAN is ambiguous
    assert lines == {"r0": "C\tr0\t2\t7\tA:1\t3:1\t2:2\t4:1\n"}
    ctl = reference.kraken_lines(dep, pool, np.array([0]), "cpu",
                                 control=True)
    assert ctl == {"r0": "C\tr0\t3\t7\tA:1\t3:3\t4:1\n"}


def test_unclassified_and_missing():
    dep = _dep()
    pool = pool_of([np.frombuffer(b"GGGG", np.uint8),
                                  np.frombuffer(b"ACGGG", np.uint8)])
    assert reference.kraken_lines(dep, pool, np.array([0, 1]), "cpu") == {
        "r0": None, "r1": "C\tr1\t3\t5\tM:2\t3:1\n"}


def _image(keys, taxa, lgnb=4):
    """A slot image of ``keys`` placed by hand: each key in its first
    bucket's first free slot (inline values)."""
    nb = 1 << lgnb
    vbits = np.uint64(lgnb - 2)
    uniq = np.unique(np.asarray(taxa, np.uint64) << np.uint64(32))
    slots = np.zeros((nb, 4), np.uint64)
    h = reference.splitmix64(np.asarray(keys, np.uint64))
    for hk, t in zip(h, taxa):
        b = int(hk & np.uint64(nb - 1))
        j = int(np.flatnonzero(slots[b] == 0)[0])
        vi = np.searchsorted(uniq, np.uint64(t) << np.uint64(32))
        slots[b, j] = (reference.OCCUPIED | ((hk >> np.uint64(lgnb)) << vbits)
                       | np.uint64(vi))
    return slots, uniq


def test_a_slot_image_read_back_by_hand():
    keys = np.array([3, 6, 27], np.uint64)
    taxa = [4, 3, 2]
    slots, uniq = _image(keys, taxa)
    held, got = reference.image_taxa(slots, uniq, True, keys)
    assert held == 3 and got.tolist() == taxa
    assert reference.map_differ(np.array(taxa), got, held) == 0
    # a key dropped: missing, and one key fewer held
    slots2, uniq2 = _image(keys[:2], taxa[:2])
    held, got = reference.image_taxa(slots2, uniq2, True, keys)
    assert got.tolist() == [4, 3, 0]
    assert reference.map_differ(np.array(taxa), got, held) == 2
    # a key under another taxon
    slots3, uniq3 = _image(keys, [4, 3, 4])
    held, got = reference.image_taxa(slots3, uniq3, True, keys)
    assert reference.map_differ(np.array(taxa), got, held) == 1
