"""Port parity: the database build, on the device path and on the host.

The plain torch versions of KB2 ``sort_unique`` and KB3 ``merge_fold``
are held against the JAX package's ``_dedup_chunk_impl`` and
``_merge_states_impl`` on the same numpy inputs (the valid prefix and its
count n; the payload JAX leaves in pad slots is unspecified), the device
folds and maps against ``bonsai_tpu.db.build_device`` and the host maps
against ``bonsai_tpu.db.build``, all on the CPU, also across chunk edges
for the uncanonical windowed, entropy-file and spaced disciplines.  The
port CLI's ``--device-build --device cpu`` builds reproduce the golden
manifest's digests (phase 2 of ``min_td_k25_w37`` and ``min_fc_k25_w37``
too), and the JAX CLI's where no golden holds the discipline (``-C -w``,
``-C -w -e``, ``-S -w``, ``prebuild -S``, and the phase 2 of ``-C -w -t``
and ``-S -w -t``).  Tolerance: exact equality, since everything here is
integer work.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db import build as jbuild
from bonsai_tpu.db import build_device as jbd
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.core.spacer import Spacer
from bonsai_tpu_torch.db import build as tbuild
from bonsai_tpu_torch.db import build_device as bd
from bonsai_tpu_torch.db.formats import load_database
from bonsai_tpu_torch.taxonomy.tree import TAX_MISSING, TaxTree

from conftest import random_dna

torch.set_num_threads(1)
GOLD = os.path.join(os.path.dirname(__file__), "data", "golden")
MANIFEST = json.load(open(os.path.join(GOLD, "manifest.json")))
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                           "g_rand.fa")]
# 1 -> {2, 3}; 2 -> {11, 12}; 3 -> {13}; plus a second root 5 -> {51}
PARENTS = {1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3, 5: 0, 51: 5}
U64_MAX = np.uint64(2**64 - 1)


@pytest.fixture(scope="module")
def trees():
    return JTree(PARENTS), TaxTree(PARENTS)


def _t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _tables_equal(a, b):
    np.testing.assert_array_equal(a.keys_sorted, b.keys_sorted)
    np.testing.assert_array_equal(np.asarray(a.vals_sorted, dtype=np.uint64),
                                  np.asarray(b.vals_sorted, dtype=np.uint64))


# -- KB2 plain vs _dedup_chunk_impl --------------------------------------------

@pytest.mark.parametrize("kind", ["dups", "u64max", "allpad", "below2^50",
                                  "allequal", "middledigit", "oneemitted",
                                  "ragged"])
def test_sort_unique_plain_matches_jax_dedup(kind):
    """The cases the kernel's radix passes treat apart: keys below 2^50
    (the top digit's pass is skipped), every key equal, keys that differ
    in one middle digit only, one emitted key, a ragged last tile
    (E = 3 * 4096 + 1)."""
    rng = np.random.default_rng(len(kind))
    E = 3 * 4096 + 1 if kind == "ragged" else 4096
    keys = rng.integers(0, 2**64, E, dtype=np.uint64)
    keys[rng.integers(0, E, 2000)] = keys[rng.integers(0, E, 2000)]
    if kind == "u64max":  # real U64_MAX keys (k = 32, uncanonical)
        keys[rng.integers(0, E, 40)] = U64_MAX
    elif kind == "below2^50":
        keys >>= np.uint64(14)
    elif kind == "allequal":
        keys[:] = keys[0]
    elif kind == "middledigit":
        digit = np.uint64(0xFF << 24)
        keys = (keys[0] & ~digit) | ((keys & np.uint64(0xFF)) << np.uint64(24))
    emitted = rng.random(E) < (0.0 if kind == "allpad" else 0.7)
    if kind == "oneemitted":
        emitted[:] = False
        emitted[E // 2] = True
    jk, jp, jn = jbd._dedup_chunk_jit()(
        jnp.asarray(np.where(emitted, keys, U64_MAX)),
        jnp.asarray((~emitted).astype(np.uint8)))
    tk, tp, tn = bd.sort_unique(_t64(keys), torch.from_numpy(emitted))
    n = int(jn)
    assert int(tn) == n
    np.testing.assert_array_equal(tk.numpy().view(np.uint64)[:n],
                                  np.asarray(jk)[:n])
    np.testing.assert_array_equal(tp.numpy()[:n], np.asarray(jp)[:n])
    assert (tp.numpy()[n:] == 1).all() and (tk.numpy()[n:] == -1).all()
    if kind == "u64max":
        assert np.asarray(jk)[n - 1] == U64_MAX and np.asarray(jp)[n - 1] == 0


# -- KB3 plain vs _merge_states_impl -------------------------------------------

def _jax_state(rng, jt, pool, n, cap, counts):
    keys = np.sort(rng.choice(pool, n, replace=False))
    taxa = rng.choice(np.array([0, 11, 12, 13, 2, 51, 999], np.uint32), n)
    kp = np.full(cap, U64_MAX, np.uint64)
    kp[:n] = keys
    pad = np.ones(cap, np.uint8)
    pad[:n] = 0
    node = np.zeros(cap, np.int32)
    node[:n] = jt.compact(taxa, missing_ok=True)
    orig = np.zeros(cap, np.uint32)
    orig[:n] = taxa
    cnt = np.zeros(cap, np.uint32)
    cnt[:n] = rng.integers(1, 5, n) if counts else 1
    return jbd._State(*(jnp.asarray(a) for a in (kp, pad, node, orig, cnt)), n)


@pytest.mark.parametrize("sum_counts", [False, True])
@pytest.mark.parametrize("na,ca,nb,cb", [(700, 1024, 900, 1024),
                                         (0, 8, 30, 32)])
def test_merge_fold_plain_matches_jax_merge(trees, sum_counts, na, ca, nb, cb):
    """The very same two states, built in JAX, merged in both packages."""
    jt, tt = trees
    rng = np.random.default_rng(na + sum_counts)
    pool = rng.integers(0, 2**64, 1200, dtype=np.uint64)
    pool[:3] = [U64_MAX, 1 << 63, 0]
    a = _jax_state(rng, jt, pool, na, ca, sum_counts)
    b = _jax_state(rng, jt, pool, nb, cb, sum_counts)
    root1 = int(jt.compact(np.array([1], np.uint32))[0])
    jout = jbd._merge_states_jit()(
        a.keys, a.pad, a.node, a.orig, a.cnt, b.keys, b.pad, b.node, b.orig,
        b.cnt, jt.device_arrays(), sum_counts=sum_counts, root1_node=root1)
    ta, tb = (bd.State.from_numpy(*(np.asarray(x) for x in
                                    (s.keys, s.pad, s.node, s.orig, s.cnt)),
                                  s.n, "cpu") for s in (a, b))
    got = bd.merge_fold(ta, tb, tt.device_arrays("cpu"), root1, sum_counts)
    keys, pad, node, orig, cnt, n = got.numpy()
    assert n == int(jout[5]) and got.cap == ca + cb
    for g, w in zip((keys, pad, node, orig, cnt), jout[:5]):
        np.testing.assert_array_equal(g[:n], np.asarray(w)[:n])
    assert (pad[n:] == 1).all() and (keys[n:] == U64_MAX).all()


# -- folds ---------------------------------------------------------------------

def _to_runs(d):
    out = {}
    for k, t in d.items():
        out.setdefault(t, []).append(k)
    return [(np.sort(np.array(ks, dtype=np.uint64)), t)
            for t, ks in sorted(out.items())]


def test_device_fold_runs_corner_semantics(trees):
    """k1 lca 2, k2 lca 1, k3 zero identity, k4 all-same-missing, k5
    missing poison, k6 disjoint roots, k7 0 with 0, k8 in one run only."""
    jt, tt = trees
    runs = _to_runs({10: 11, 20: 11, 30: 11, 40: 999, 50: 999, 60: 11, 70: 0,
                     80: 12}) + _to_runs({10: 12, 20: 13, 30: 0, 40: 999,
                                          50: 11, 60: 51, 70: 0})
    dk, dt, dc = bd.device_fold_runs(runs, tt, want_counts=True, device="cpu")
    jk, jt_, jc = jbd.device_fold_runs(runs, jt, want_counts=True)
    for g, w in ((dk, jk), (dt, jt_), (dc, jc)):
        np.testing.assert_array_equal(g, w)
    assert dict(zip(dk.tolist(), dt.tolist())) == {
        10: 2, 20: 1, 30: 11, 40: 999, 50: TAX_MISSING, 60: 1, 70: 0, 80: 12}
    hk, ht, hc = tbuild.lca_fold_runs(np.zeros(0, np.uint64),
                                      np.zeros(0, np.uint32), runs, tt,
                                      want_counts=True)
    for g, w in ((hk, dk), (ht, dt), (hc, dc)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("want_counts", [False, True])
def test_device_fold_runs_tree_reduction_matches_jax(trees, want_counts):
    jt, tt = trees
    rng = np.random.default_rng(3)
    runs = [(np.unique(rng.integers(0, 300, 80).astype(np.uint64)), t)
            for t in (11, 12, 13, 11, 12, 51, 13, 999, 0)]
    got = bd.device_fold_runs(runs, tt, want_counts=want_counts, device="cpu")
    want = jbd.device_fold_runs(runs, jt, want_counts=want_counts)
    assert len(got) == len(want) == 2 + want_counts
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- maps ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Three synthetic genomes of two contigs with 1% Ns (as
    tests/test_build_device.py writes them)."""
    tmp = tmp_path_factory.mktemp("genomes")
    rng = np.random.default_rng(7)
    paths, name_map = [], {}
    for i in range(3):
        p = str(tmp / f"g{i}.fa")
        with open(p, "w") as fh:
            for ci, clen in enumerate((3000, 1200)):
                seq = random_dna(rng, clen, n_prob=0.01).decode()
                fh.write(f">ACC_{i}_{ci} synthetic\n{seq}\n")
        paths.append(p)
        name_map[f"ACC_{i}_0"] = [11, 12, 13][i % 3]
    return paths, name_map


@pytest.mark.parametrize("k,w,canon", [(31, 31, True), (21, 40, True),
                                       (17, 17, False)])
def test_device_lca_map_matches_jax(trees, genomes, k, w, canon):
    jt, tt = trees
    paths, name_map = genomes
    want = jbd.device_lca_map(paths, jt, name_map, JSpacer(k, w),
                              canonicalize=canon, block=1 << 10)
    got = bd.device_lca_map(paths, tt, name_map, Spacer(k, w), canon,
                            block=1 << 10, device="cpu")
    assert want.n > 0
    _tables_equal(got, want)


def test_device_phase1_maps_match_jax(trees, genomes):
    jt, tt = trees
    paths, name_map = genomes
    for jfn, tfn in ((jbd.device_taxdepth_map, bd.device_taxdepth_map),
                     (jbd.device_ftct_map, bd.device_ftct_map)):
        want = jfn(paths, jt, name_map, JSpacer(25, 25), block=1 << 10)
        got = tfn(paths, tt, name_map, Spacer(25, 25), block=1 << 10,
                  device="cpu")
        _tables_equal(got, want)


def test_host_windowed_lca_map_matches_jax(trees, genomes):
    jt, tt = trees
    paths, name_map = genomes
    want = jbuild.lca_map(paths, jt, name_map, JSpacer(21, 40))
    got = tbuild.lca_map(paths, tt, name_map, Spacer(21, 40))
    assert want.n > 0
    _tables_equal(got, want)


def test_host_windowed_chunks_match_jax(genomes):
    """Halo-overlapped chunks of 1024 windows emit what the JAX host
    encoder's chunks emit."""
    from bonsai_tpu.core.alphabet import DNA4
    from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
    from bonsai_tpu.io.fastx import read_fastx

    from bonsai_tpu_torch.core.encoder import BatchEncoder

    seq = next(iter(read_fastx(genomes[0][0])))[1]
    want = jbuild._contig_sets(JEncoder(JSpacer(21, 40)), seq, DNA4.lut,
                               JSpacer(21, 40), 1 << 10, False)
    got = tbuild._contig_sets(BatchEncoder(Spacer(21, 40)), seq, DNA4.lut,
                              Spacer(21, 40), 1 << 10)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.unique(g), w)


def test_host_phase1_maps_match_jax(trees, genomes):
    jt, tt = trees
    paths, name_map = genomes
    for jfn, tfn in ((jbuild.taxdepth_map, tbuild.taxdepth_map),
                     (jbuild.ftct_map, tbuild.ftct_map)):
        _tables_equal(tfn(paths, tt, name_map, Spacer(25, 25)),
                      jfn(paths, jt, name_map, JSpacer(25, 25)))


# -- the CLI -------------------------------------------------------------------

def _golden(name):
    return next(c for c in MANIFEST["configs"] if c["name"] == name)


@pytest.mark.parametrize("name", ["lex_k25", "lex_k31_w40", "lex_k25_nocanon",
                                  "spaced_k21", "ent_k25_w37",
                                  "min_td_k25_w37", "min_fc_k25_w37"])
def test_cli_device_build_matches_golden_digest(name, tmp_path):
    c = _golden(name)
    out = str(tmp_path / "db.btpu")
    nodes = os.path.join(GOLD, "nodes.dmp")
    nmap = os.path.join(GOLD, "nameidmap.txt")
    dev = ["--device-build", "--device", "cpu"]
    if c["phase1"] is None:
        argv = ["build", out, *GENOMES, *c["flags"], "-T", nodes, "-M", nmap]
        want = c["db_digest"]
    else:
        argv = ["prebuild", nmap, nodes, out, *GENOMES, "-k", "25",
                f"-{c['phase1']}"]
        want = c["phase1_digest"]
    assert cli.main(argv + dev) == 0
    assert tbuild.content_digest(load_database(out).table) == want
    host = str(tmp_path / "host.btpu")
    argv[argv.index(out)] = host
    assert cli.main(argv) == 0
    assert tbuild.content_digest(load_database(host).table) == want


@pytest.mark.parametrize("argv,phase1", [
    (["build", "-C", "-k", "25", "-w", "37"], None),
    (["build", "-C", "-k", "25", "-w", "37", "-e"], None),
    (["build", "-k", "21", "-S", "0x16,1x4", "-w", "40"], None),
    (["build", "-k", "21", "-S", "0x16,1x4", "-w", "40", "-e"], None),
    (["prebuild", "-k", "21", "-S", "0x16,1x4", "-t"], None),
    (["prebuild", "-k", "21", "-S", "0x16,1x4", "-f"], None),
    (["build", "-C", "-k", "25", "-w", "37", "-t"], ["-C", "-k", "25", "-t"]),
    (["build", "-k", "21", "-S", "0x16,1x4", "-w", "40", "-t"],
     ["-k", "21", "-S", "0x16,1x4", "-t"]),
], ids=["uncanonical-w37", "uncanonical-w37-entropy", "spaced-w40",
        "spaced-w40-entropy", "prebuild-spaced-t", "prebuild-spaced-f",
        "uncanonical-w37-phase2-t", "spaced-w40-phase2-t"])
def test_cli_build_matches_jax_digest(argv, phase1, tmp_path):
    """The disciplines no golden holds, against the JAX CLI's database:
    the host build and --device-build --device cpu.  A phase 2 takes the
    phase-1 map that the JAX CLI's prebuild with ``phase1`` writes."""
    from bonsai_tpu.cli import main as jmain

    nodes = os.path.join(GOLD, "nodes.dmp")
    nmap = os.path.join(GOLD, "nameidmap.txt")
    p1_args = []
    if phase1 is not None:
        p1 = str(tmp_path / "p1.btpu")
        assert jmain(["prebuild", nmap, nodes, p1, *GENOMES, *phase1]) == 0
        p1_args = ["--phase1-db", p1]

    def argv_for(out):
        if argv[0] == "build":
            return ["build", out, *GENOMES, *argv[1:], *p1_args, "-T", nodes,
                    "-M", nmap]
        return ["prebuild", nmap, nodes, out, *GENOMES, *argv[1:]]

    jout = str(tmp_path / "jax.btpu")
    assert jmain(argv_for(jout)) == 0
    want = tbuild.content_digest(load_database(jout).table)
    assert load_database(jout).table.n > 0
    for tag, extra in (("host", []),
                       ("device", ["--device-build", "--device", "cpu"])):
        out = str(tmp_path / f"{tag}.btpu")
        assert cli.main(argv_for(out) + extra) == 0
        db = load_database(out)
        assert tbuild.content_digest(db.table) == want, tag
        assert db.gaps == load_database(jout).gaps
        assert db.scheme == load_database(jout).scheme


@pytest.mark.parametrize("k,w,gaps,canon,scheme", [
    (25, 37, None, False, "lex"),
    (25, 37, None, False, "entropy-file"),
    (25, 37, None, True, "entropy-file"),
    (21, 40, "0x16,1x4", False, "lex"),
    (21, 25, "0x16,1x4", False, "entropy-file"),
], ids=["uncanonical", "uncanonical-entropy", "canonical-entropy",
        "spaced-w40", "spaced-entropy"])
def test_device_lca_map_disciplines_match_jax(trees, genomes, k, w, gaps,
                                              canon, scheme):
    """Chunks of 1024 windows, so the contigs of 3000 and 1200 bases cross
    chunk edges: a non-final chunk drops its column 0 where the JAX
    package does (w > c, uncanonical), on the device path and the host
    path alike."""
    jt, tt = trees
    paths, name_map = genomes
    want = jbd.device_lca_map(paths, jt, name_map, JSpacer(k, w, gaps),
                              canon, scheme, block=1 << 10)
    got = bd.device_lca_map(paths, tt, name_map, Spacer(k, w, gaps), canon,
                            scheme, block=1 << 10, device="cpu")
    assert want.n > 0
    _tables_equal(got, want)
    from bonsai_tpu.core.alphabet import DNA4
    from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
    from bonsai_tpu.io.fastx import read_fastx

    from bonsai_tpu_torch.core.encoder import BatchEncoder

    seq = next(iter(read_fastx(paths[0])))[1]
    jsets = jbuild._contig_sets(JEncoder(JSpacer(k, w, gaps), canon, scheme),
                                seq, DNA4.lut, JSpacer(k, w, gaps), 1 << 10,
                                False)
    tsets = tbuild._contig_sets(BatchEncoder(Spacer(k, w, gaps), canon,
                                             scheme),
                                seq, DNA4.lut, Spacer(k, w, gaps), 1 << 10)
    assert len(tsets) == len(jsets) == 3
    for g, j in zip(tsets, jsets):
        np.testing.assert_array_equal(np.unique(g), j)


def test_partial_window_of_a_non_final_chunk_is_dropped(trees, tmp_path):
    """A contig whose second chunk (of 1024 windows) holds 4 valid seeds
    amid Ns: there the uncanonical windowed discipline's tail fires, and
    only that emission carries their minimum.  The JAX package drops it,
    as a non-final chunk's, on both paths; so must the port."""
    jt, tt = trees
    rng = np.random.default_rng(11)
    seq = bytearray(random_dna(rng, 3000, n_prob=0.0))
    seq[1024:2100] = b"N" * 1076
    seq[1500:1528] = random_dna(rng, 28, n_prob=0.0)  # 4 seeds of k = 25
    path = str(tmp_path / "nrich.fa")
    with open(path, "w") as fh:
        fh.write(f">ACC_9_0 nrich\n{seq.decode()}\n")
    name_map = {"ACC_9_0": 11}
    sp, jsp = Spacer(25, 37), JSpacer(25, 37)
    from bonsai_tpu_torch.core.encoder import BatchEncoder
    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.io import fastx

    codes = torch.from_numpy(fastx.encode_contig(bytes(seq[1024:2084]),
                                                 DNA4.lut))
    em = BatchEncoder(sp, False).emissions(
        codes[None, :], torch.tensor([1060], dtype=torch.int32))
    assert bool(em.mask[0, 0]) and int(em.mask.sum()) == 1  # the tail alone
    want = jbd.device_lca_map([path], jt, name_map, jsp, False, "lex",
                              block=1 << 10)
    assert int(em.values[0, 0]) & (2**64 - 1) not in set(
        want.keys_sorted.tolist())
    _tables_equal(bd.device_lca_map([path], tt, name_map, sp, False, "lex",
                                    block=1 << 10, device="cpu"), want)
    from bonsai_tpu.core.encoder import BatchEncoder as JEncoder

    jsets = jbuild._contig_sets(JEncoder(jsp, False), bytes(seq), DNA4.lut,
                                jsp, 1 << 10, False)
    tsets = tbuild._contig_sets(BatchEncoder(sp, False), bytes(seq), DNA4.lut,
                                sp, 1 << 10)
    assert len(tsets) == len(jsets) == 3
    for g, j in zip(tsets, jsets):
        np.testing.assert_array_equal(np.unique(g), j)


@pytest.mark.parametrize("extra", [["-t", "--phase1-db", GENOMES[0]],
                                   ["--bonsai-format", "-k", "40"],
                                   ["--shards", "2", "-k", "33"],
                                   ["-S", "0x16,1x4", "-k", "40"],
                                   ["--bonsai-format", "-z", "-k", "64"],
                                   ["-k", "33"]])
def test_cli_refuses_what_is_not_ported(extra, tmp_path, capsys):
    """A build of k > 32 (with any output format, sharded or khash) exits
    2 naming its ROADMAP item; a --phase1-db that is neither BTPU1 nor a
    reference khash image (a FASTA file) exits 2 saying so, before any
    build."""
    argv = ["build", str(tmp_path / "x.btpu"), GENOMES[0], "-T",
            os.path.join(GOLD, "nodes.dmp"), "-M",
            os.path.join(GOLD, "nameidmap.txt"), *extra]
    assert cli.main(argv) == 2
    want = ("neither a BTPU1 file nor a reference khash"
            if "--phase1-db" in extra else "ROADMAP queue A, item 8.6")
    assert want in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.btpu")


@pytest.mark.parametrize("flag", ["-t", "-f"])
def test_cli_phase2_needs_a_phase1_db(flag, tmp_path, capsys):
    """As the JAX CLI: -t/-f without --phase1-db returns 1."""
    out = tmp_path / "x.btpu"
    assert cli.main(["build", str(out), GENOMES[0], "-k", "25", "-w", "37",
                     flag, "-T", os.path.join(GOLD, "nodes.dmp"), "-M",
                     os.path.join(GOLD, "nameidmap.txt")]) == 1
    assert "-t/-f build requires --phase1-db" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("name", ["min_td_k25_w37", "min_fc_k25_w37"])
@pytest.mark.parametrize("where", ["host", "device"])
def test_cli_phase2_matches_golden_digest(name, where, tmp_path):
    """build -t|-f --phase1-db after the port's own prebuild: the reference
    binary's db_digest, on the host and with --device-build --device cpu
    (-e beside -t/-f is ignored, as in the JAX CLI)."""
    c = _golden(name)
    nodes = os.path.join(GOLD, "nodes.dmp")
    nmap = os.path.join(GOLD, "nameidmap.txt")
    p1, out = str(tmp_path / "p1.btpu"), str(tmp_path / "p2.btpu")
    assert cli.main(["prebuild", nmap, nodes, p1, *GENOMES, "-k", "25",
                     f"-{c['phase1']}"]) == 0
    dev = ["--device-build", "--device", "cpu"] if where == "device" else []
    assert cli.main(["build", out, *GENOMES, *c["flags"], f"-{c['phase1']}",
                     "--phase1-db", p1, "-e", "-T", nodes, "-M", nmap,
                     *dev]) == 0
    db = load_database(out)
    assert tbuild.content_digest(db.table) == c["db_digest"]
    assert db.scheme == "hash" and (db.k, db.w) == (25, 37)
