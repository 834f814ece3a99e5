#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device      CUDA present; the card's name and power limit
  2. build       the kernels (csrc/*.cu, one nvcc per source, all started
                 together) and the port's host C++ (native/src)
  3. kernels     K1-K3 against their plain torch versions on CPU copies
                 of the same inputs, exact equality (integer work):
                 HiSeq batches of 8192 reads against the ec k=31 table,
                 in-read Ns, reads shorter than k, paired rows, long reads
                 (P > 1024: resolve's block-per-read kernel), run-overflow
                 rows and every compact layout for step_outputs; K1 in
                 each batch's N channel, and where it is the sparse list
                 also against K1's mask instantiation on the same reads
                 (HiSeq 8192, paired, and with a list exactly cap = 256
                 long, Ns at column 0, len - 1 and word edges); resolve
                 also on a taxonomy with a parent cycle under both tie
                 rules, on a 2^21-node taxonomy with lineages 25-40 deep
                 (tools/synthetic.py), and at 0, 1, 2 and one-taxon
                 hits a row
  4. database    the ec k=31 database built by the port on the host; its
                 content digest must equal the golden manifest's; upload
  5. classify    Classifier.process_dataset on the HiSeq, MiSeq and
                 ec_k12 sets in batches of 8192 and of the CLI's 4096:
                 sha256 of the Kraken text must equal the manifest's, and
                 each batch's N channel (none, sparse, mask; printed) the
                 JAX package's (SET_CHANNELS); K1 (mask or none, and
                 sparse), K2, K3 launched; paired golden through the CLI
                 on the lex_k25 database
  6. numbers     K1 (mask, and sparse), K2, K3 and plain-version times
                 by CUDA-graph replay of captured calls, with the event
                 timing of back-to-back wrapper calls beside them, K1 mask
                 and sparse again in turns; the upload bytes a read of
                 each N channel; K2 again on the deep tree's rows; the
                 HiSeq stream's reads/s through the classifier (sparse)
                 and through the same arrays with _sparse_n_ok False
                 (mask), in turns sparse, mask, mask, sparse; after phase 10, K1's
                 slot rows at G1's random 32-B row rate (a yardstick,
                 not a bound: K1 reads its rows faster than G1)
  7. scale       a 2^26-key table (1 GiB of slots) probed by K1, checked
                 against the host probe on a 1M-query subsample
  8. build kernels  KB1-KB3, G1 and G2 against their plain versions on
                 CPU copies, exact equality: a 4M-base ec chunk at W = 1
                 and 10, uncanonical, in-read Ns, k = 32 with bit 63 and
                 real U64_MAX keys, rows shorter than k, P < W; chunks
                 with duplicates, all pads, 4.2M keys, KB2's radix edge
                 cases (a skipped top digit, one run, one middle digit,
                 one key, a ragged tile, 2^22 keys) and two calls in a
                 row; KB1 with Ns at the ends of a thread's run and at tile
                 edges, N runs longer than k, a ragged L, W = 2, 10, 17;
                 the eight lca() corners, KB3 pairs across tile edges (the
                 corners there, both state orders, a real U64_MAX pair),
                 whole tiles of pairs, empty and tiny states, two calls in
                 a row and 2^22 + 2^22 random states, both sum_counts;
                 the gathers at the shapes of
                 their TPU cases, G2 also at a ragged Q and at axis 1
                 with Ci != Ct; the seed disciplines of -S, -e and -C -w:
                 KB1's spaced and entropy-file instantiations and KB4 on
                 4M-base ec chunks (-S at W = 1 and 16, -e at W = 13, -C
                 at W = 10, -C -e at W = 13), on rows with in-read Ns, N
                 runs longer than the span, all-N rows, rows shorter than
                 the span, 0 < n_valid < W tails, k = 32 with bit 63 and
                 real U64_MAX k-mers, at W = 1, 2, 13, 16, with Ns at tile
                 edges, and KB4 on 3000 short rows and twice in a row
  9. device build   the port's --device-build: ec k=31 (digest = the
                 manifest's), k=31 w=40, -k 21 -S 0x16,1x4, -k 25 -w 37 -e
                 and -C -k 31 -w 40 (digests = the JAX package's), then
                 the lex_k25, lex_k31_w40, lex_k25_nocanon, spaced_k21,
                 ent_k25_w37 builds, the prebuild -t/-f phase-1 maps of the
                 goldens and, against the JAX package's digests, -C -w,
                 -C -w -e, -S -w -e and prebuild -S -t through the CLI;
                 KB1 (each instantiation), KB2-KB4 launched; seconds,
                 k-mers/s against the host build, peak device memory,
                 device busy share
 5b. spaced classify  after phase 9, K1's spaced instantiations (mask or
                 none, and sparse) against their plain versions on HiSeq
                 batches against the spaced ec database of phase 9
                 (in-read Ns, short reads, pairs; sparse also against the
                 mask instantiation), then Classifier.process_dataset of
                 the HiSeq set against it: sha256 of the Kraken text = the
                 JAX Classifier's, its batches in the JAX package's N
                 channels (sparse); K1 (spaced sparse) launched; K1
                 spaced and plain timed
 9c. hash-scored phase 2  after phase 5b: the ec phase-1 maps (-k 25 -t,
                 -k 25 -f, -C -k 25 -t, -k 21 -S 0x16,1x4 -t) built on the
                 card (digests = the JAX package's); KB5 lookup_scores and
                 KB1's and KB4's score::Hash instantiations against their
                 plain versions on CPU copies, exact: 2^22 k-mers half
                 present (0 and U64_MAX among them) on the -t map and on a
                 flat image, 4M-base ec chunks at the builds' shapes
                 (-w 37 -t, -S -w 40 -t, -C -w 37 -t), rows with in-read
                 Ns, a poly-A run, rows shorter than k, P < W, rows phase 1
                 lacks, Ns at tile edges, k = 32 spaced with U64_MAX
                 stored, 0 < n_valid < W tails, KB4 twice in a row; then
                 the ec --device-build phase 2 of each map (digests = the
                 JAX package's host minimized_map), one of them by stage
                 (genomes -> states, tree fold, KB5 + fetch, the host
                 probe, placement) under the profiler, min_td_k25_w37 and
                 min_fc_k25_w37 through the CLI (the reference binary's
                 db_digest) and -C -w -t, -S -w -t (the JAX CLI's); KB5,
                 KB1 hash and spaced hash, KB4 hash launched; HiSeq
                 against the ec -k 25 -w 37 -t database (sha256 = the JAX
                 Classifier's); the four kernels and their plain versions
                 timed by CUDA-graph replay at those shapes, with bounds,
                 and each hash instantiation's slot rows a ms (G rows/s,
                 beside KB5's on the same kind of map) and blocks a SM
 9d. Python API  after phase 9c: the Shannon terms made on this host
                 (sha256 = the JAX package's host's); through
                 bonsai_tpu_torch.api on the card, each sha256 = the JAX
                 package's bonsai_tpu.api: seqdict over the 5 ec genomes at
                 -k 31 -w 40, get_kmers of every ec record at -k 31 -w 40
                 entropy (canonical; under the profiler: Mbases/s and the
                 card's busy share) and -k 21 -S 0x16,1x4 -w 40 entropy
                 (uncanonical), of the K-12 genome at -k 13 -w 29 entropy
                 (both), of its three forward frames translated by the
                 standard code as PROTEIN20 -k 7 and -k 7 -w 20 entropy,
                 PROTEIN_14 -k 10 -w 24, PROTEIN_6 -k 12 -S 1x11 -w 30
                 entropy, PROTEIN -k 8, PROTEIN_3BIT -k 22; rolling_hashes of
                 K-12 at k = 31 and 64 canonical and 200; KB1's and KB4's
                 Shannon and radix instantiations and KR1 launched; each
                 against its plain version on CPU copies, exact: 1M-base
                 slices at those shapes, rows of every kind and alphabet
                 (Ns at tile edges, N runs longer than the span, all-N rows,
                 rows shorter than the span, 0 < n_valid < W tails, bytes
                 past 127, a real U64_MAX), KR1 at k = 1, 63, 64, 65, 1000;
                 then each timed by CUDA-graph replay at the K-12 shape (a
                 protein frame for the radix rows), with its bound
 9e. sketches    after phase 9d, the sketch front-ends through
                 bonsai_tpu_torch on the card, against the JAX package's
                 values: kmercnt's counts (MultiKCounter, KR1 and KS3) of
                 the 5 ec genomes at -k 17,21,25,29,31 (canonical and not)
                 and --nthash -k 21,31: the sha256 of every .shs content
                 and of the .bin at k = 31, the counts of every k summing
                 to the windows without an N; kmercnt -k 31 -C --shs-only
                 through the CLI; rolling-multk (text) and
                 rolling-multk-sketch -z 1024 (cardinalities); setsketch
                 -k 31 -z 4096 -S -s, -c -k 31 -z 4096 -S and -k 40 -z
                 4096 -S -s of each genome and their union (KB1 or KR1,
                 then KS2): ids, idcounts and n_updates equal, the
                 cardinalities within 1e-9; distmat -k 31 exact and --hll
                 14 (KS1; each pair's union estimated alone); cmpshs of the
                 k = 31 .shs; KS4 (wang_hash, khash_int64_hash,
                 popcount64, nuccount, gccount, and the library functions
                 frev64_inv, wang_hash_inv, lrot 31, rrot 17) on the K-12
                 31-mers (sha256 = the JAX package's); KS1-KS4, each KS4
                 mode, launched; then each against its plain version on CPU
                 copies (exact, but KS2's registers within 2 ulp, the count
                 that differ printed): KS1 at p = 4, 14, 16, 17, 20 on both
                 paths with keys whose h << p is 0 and U64_MAX, KS2 at m =
                 1, 64, 4096 in each mode on an empty update, one element,
                 copies across chunks and all copies of one k-mer over a
                 chunk of 2^16 + 1, and on the K-12 stream, KS3 with runs
                 past 65,535, bit 63 set, E = 0 and 1, KS4 at k = 1, 31, 32,
                 its inverse mixes on the edges and through round trips,
                 its rotate at r = 0, 1, 31, 32, 63 (lrot 64, rrot 65);
                 then each timed at the K-12 shape with its bound, KS3
                 beside torch.unique(return_counts=True)
 9f. formats     after phase 9e, the database formats and the encoders'
                 tail through bonsai_tpu_torch on the card, against the
                 JAX package's values: build --shards 4, --shards auto (->
                 1) and --bonsai-format of the ec k=31 database through
                 the port's CLI (KS5 places the shards), the sha256 of
                 every shard file, manifest.json, uniq_vals.npy and of the
                 khash file = the JAX CLI's (EC_DB_CMD); classify of the
                 HiSeq set against the sharded directory (a merged load),
                 the khash file and a probe-image of the .btpu file (the
                 golden sha256); KS5's owners of the ec keys at ndb = 1,
                 3, 4, 65536; K128's pack, rc, canonical and canonical
                 pack of K-12 at k = 33, 40, 55, 64; RollingEncoder
                 .emissions of K-12 at k = 31 w = 40 canonical and k = 64
                 w = 100 (KR1, then KB4's stream source); KS5, K128 and
                 KB4's stream source launched (and K1-K3, KR1); the wall
                 seconds of each build, the sharded save, the khash
                 write and read, the merged load and each classify; then
                 each new kernel against its plain version on CPU copies
                 (bit 63 set in either lane, 0 and U64_MAX keys, an all-N
                 row, P = 1, Ns at run and tile edges, codes past 3,
                 W = 1, 37 and 8192, rows shorter than the window, an
                 all-invalid row, 0 < n_valid < W) and each timed by
                 CUDA-graph replay at the ec keys or K-12, with its bound
 9g. sharded     after phase 9f, the sharded classifier and build on the
                 card, its ranks in this one process sharing the card (so no
                 rate here is a multi-GPU rate): a2a at (dp, db) = (1, 4),
                 (2, 2) and psum at (1, 4) over the ec k=31 database (the
                 HiSeq, MiSeq and ec_k12 sha256s of phase 5), the HiSeq
                 stream x 20 through a2a (1, 4) with the card's busy share,
                 a2a at cf 0.05 (rounds > 1, sha256 unchanged),
                 process_dataset_distributed + merge-parts, classify
                 --db-shards 1 through the CLI (psum, one rank) and
                 --db-shards 4 refused with the JAX CLI's divisibility
                 message, the paired golden through both routes at (1, 2),
                 phase 9f's --shards 4 directory a rank at a time (db 4,
                 db 2), probe-image --db-ranks 4 and its images, a shard
                 rewritten in place (stale images ignored),
                 sharded_lca_map of the ec corpus at db 4
                 (kraken.db_digest; peak device memory), and
                 sharded_encode_contig of K-12 at sp 4 (= the unsharded
                 encode); KD1 (route_frame, route_probe, route_collect),
                 K1's encode-only and bucket-range instantiations, the
                 key-range mode and KB1's sequence-parallel instantiation
                 launched, KD1 probe's launches split into first and later
                 a2a rounds; then each against its plain version on CPU
                 copies (the first a2a round of a HiSeq batch and two
                 later ones, every query to one owner, ndb = 3, Q < ndb,
                 4M queries, taxids past 2^31, inline and flat values,
                 each psum rank, U64_MAX and the splitters among 5M keys)
                 and each timed by CUDA-graph replay at the main path's
                 shapes, with bounds; KD1's frame (cooperative) and
                 collect each one launch without a memset (profiler), KD1's
                 probe and collect of the later rounds timed, and the
                 floor of an empty launch
 10. gather      python -m bonsai_tpu_torch.tools.gather_bench's run: G1
                 at variant F's shape and 32-B rows over 16 MiB..4 GiB
                 tables, G2 at four shapes, timed by CUDA-graph replay;
                 G1 and G2 launched
 11. numbers     KB1-KB4 and plain-version times at the build's shapes
                 (KB1 and KB4 by CUDA-graph replay as well, KB1 for each
                 instantiation), KB2 at three chunks (k=31 W=10, k=25
                 W=1, k=31 W=1) with torch.unique beside it; index_select
                 and gather at G1's and G2's shapes; each kernel's bound
                 (tools/bounds.py: bytes over 3.35 TB/s, or int32
                 operations over 16.7 TOP/s and FP64 ones over 34 TFLOP/s,
                 the larger)

The line before the last is the kernels JSON (launches on the main paths,
exactness, kernel, plain, bound and library times, and the share
bound / kernel time; ``ms`` is graph-replayed
for K1-K3, KB1, KB4, KB5, G2, KS5, K128 and phase 9g's kernels,
``event_ms`` the event
timing; KB1, KB4 and K1 have a row for each instantiation); each phase prints its wall
seconds as it ends ("# phase ...") and all of them before the kernels
line; the last line is {"ok": true, "device": {...}}.  Without a card,
or outside a checkout,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
GOLD = os.path.join(DATA, "golden")
SEED = 20261016
# Content digest of the ec k=31 w=40 database (1,900,793 k-mers) as the JAX
# package builds it on the host, from the repository root:
#   JAX_PLATFORMS=cpu python -c "import json; from bonsai_tpu.core.spacer \
#   import Spacer; from bonsai_tpu.db.build import lca_map; from \
#   bonsai_tpu.taxonomy.tree import TaxTree; from bonsai_tpu_torch.db.build \
#   import content_digest; g='tests/data/golden/'; kk=json.load(open(g + \
#   'manifest.json'))['kraken']; print(content_digest(lca_map(['tests/data/ec/'\
#   + x for x in kk['genomes']], TaxTree.from_nodes_dmp(g + kk['nodes']), g \
#   + kk['nameid'], Spacer(31, 40))))"
EC_W40_DIGEST = "02a018d96195a0762302fdb1ca403499790702e3ae67fbdff5a8ff512ccee936"
# The same for the seed disciplines of -S, -e and -C -w: the command above
# with lca_map(..., Spacer(k, w, parse_spacing(S, k)), canonicalize,
# scheme), parse_spacing from bonsai_tpu.core.spacer.  Each row: the
# build's flags, k, w, S, canonicalize, scheme, digest (k-mers).
EC_DISCIPLINES = [
    ("-k 21 -S 0x16,1x4", 21, 21, "0x16,1x4", True, "lex",  # 10,364,415
     "5157c57f1b71dc11d4369160794389158ff4ba36d93a0d14443aecab7dcb8d5f"),
    ("-k 25 -w 37 -e", 25, 37, "", True, "entropy-file",  # 1,499,039
     "ecd6fe2a6cb126971729461a008cb76c03673c102f5271762380b327140e34c6"),
    ("-C -k 31 -w 40", 31, 40, "", False, "lex",  # 2,060,460
     "2b49cdd87ece50cbdf67401ecdd0bad99c52f117ff0c89f9087f15c237cc1500"),
]
# sha256 of the Kraken text (every read, -a) of the HiSeq set against the
# -k 21 -S 0x16,1x4 ec database, as the JAX package's Classifier gives it
# on the CPU: Classifier(Database(table=<that lca_map>, k=21, w=21,
# gaps=parse_spacing("0x16,1x4", 21)), tree, emit_all=True)
# .process_dataset(HiSeq_accuracy.fa, out, batch_size=8192)
HISEQ_SPACED_SHA256 = (
    "a12369f482cfbc432bf4beccf6d2784edddcd02ef8fae7e8944dad2eb76b97b5")
# The in-read N channel of each batch of the kraken sets, as the JAX
# package's Classifier picks it on the CPU: [Classifier._prepare_batch(b)
# [4] for b in bonsai_tpu.io.fastx.batch_reads(<set's reads>, DNA4.lut,
# batch_size=B)] at B = 8192 (phases 5, 5b and 6) and at the CLI's -c 4096
SET_CHANNELS = {
    8192: {"HiSeq": ["sparse", "sparse"], "MiSeq": ["mask", "sparse"],
           "ec_k12": ["sparse", "sparse"]},
    4096: {"HiSeq": ["sparse", "none", "sparse"],
           "MiSeq": ["mask", "mask", "sparse"],
           "ec_k12": ["sparse", "mask", "sparse"]},
}
# Content digests of the golden genomes' databases that no golden holds,
# as the JAX package's CLI builds them (python -m bonsai_tpu build OUT
# g_phix.fa g_phixmut.fa g_rand.fa FLAGS -T nodes.dmp -M nameidmap.txt;
# prebuild nameidmap.txt nodes.dmp OUT <the genomes> FLAGS)
GOLDEN_JAX_DIGESTS = {
    ("build", "-C -k 25 -w 37"):
        "a4da014a40a21374a994a8c003aae6e8aff43a0a994dd79cf09ed65ff406fcdf",
    ("build", "-C -k 25 -w 37 -e"):
        "3fbd800a20fd86c2378d8b08ae0dc84319a2b14de16ffccc2b8a1d3bc83285fe",
    ("build", "-k 21 -S 0x16,1x4 -w 40 -e"):
        "31c3569cbc4eb63418087e88f07239d99d5f67a4b50d9a157fcde5752acb1873",
    ("prebuild", "-k 21 -S 0x16,1x4 -t"):
        "4ec67ed322b52e16259f2e53266a951e3be36e771c7df3dbee6d5b2c37371200",
}
# The ec corpus's hash-scored phase 2 as the JAX package builds it on the
# host: phase 1 = taxdepth_map (-t) or ftct_map (-f) of bonsai_tpu.db.build
# (paths, tree, nameid as for EC_W40_DIGEST, Spacer(k, k, parse_spacing(S,
# k)), canonicalize), then minimized_map(paths, <phase 1>, tree, nameid,
# Spacer(k, w, parse_spacing(S, k)), canonicalize).  Each row: the build's
# flags, k, w, S, canonicalize, the phase-1 flag, the phase-1 digest, the
# phase-2 digest (k-mers of each).
EC_PHASE2 = [
    ("-k 25 -w 37 -t", 25, 37, "", True, "t",  # 9,815,329; 1,870,305
     "0a7d297c5b53680057e3c3e137479aa28f491af9698bc4c8ae83571f2a0b94b1",
     "114dad4ce5143b8175593775f941fffad150d0cc67473d115f1d32584e5bda05"),
    ("-k 25 -w 37 -f", 25, 37, "", True, "f",  # 9,815,329; 2,063,661
     "4a799ecb6bc06f264ae2e2ff71b67040ea8d6520152def32ea91d54ae1ad7592",
     "3f47c8335ae5efc954f718b32781fb8a8c531b6bd1cac6d6192f63e236e2c2d6"),
    ("-C -k 25 -w 37 -t", 25, 37, "", False, "t",  # 10,732,336; 2,011,057
     "7e82398862be4e2d14bbd100cb5c67d58d701c366ff7d51b026da32584fc7b04",
     "a87d9efac34ffb1c7a2de15d7d762b0ce8ffff363c70b551b9d15bfe327c58ad"),
    ("-k 21 -S 0x16,1x4 -w 40 -t", 21, 40, "0x16,1x4", True, "t",
     # 10,364,415; 1,681,037
     "5d8ff555992f720f61f188565082275fbd94afbcbbec95f9ab2c0efbc3930ad2",
     "03e528bd2cc00177048ec91b1f5228d20e55f545bcc9c8500c85c647dadafdb2"),
]
# sha256 of the Kraken text of the HiSeq set against the first of them, as
# the JAX package's Classifier gives it on the CPU: Classifier(Database(
# table=<that minimized_map>, k=25, w=37, gaps=parse_spacing("", 25),
# scheme="hash"), tree, emit_all=True).process_dataset(HiSeq_accuracy.fa,
# out, batch_size=8192)
HISEQ_PHASE2_SHA256 = (
    "196b0d714590122c08c744359a7fe94d0412af741c1abfa742e9ec2bfeba07ef")
# The golden genomes' phase 2 that no golden holds, as the JAX CLI builds
# it: prebuild nameidmap.txt nodes.dmp P1 <the genomes> PHASE1, then build
# OUT <the genomes> FLAGS --phase1-db P1 -T nodes.dmp -M nameidmap.txt.
# FLAGS -> (PHASE1, digest)
GOLDEN_PHASE2_DIGESTS = {
    "-C -k 25 -w 37 -t": (
        "-C -k 25 -t",
        "3fc544b5963fdc00a6f9c39b1329f57986c807a5367f23ca6cafbc7c2e1cdb80"),
    "-k 21 -S 0x16,1x4 -w 40 -t": (
        "-k 21 -S 0x16,1x4 -t",
        "47267d9b6c51a03d6278c2bb2a2e6b1f1cccde3f1f9c58ae15187602287d3acf"),
}
SPACING21 = "0x16,1x4"
EC_GENOME = os.path.join(DATA, "ec", "GCF_000005845.2_ASM584v2_genomic.fna.gz")
# Phase 9d, the Python API: sha256 (``_digest``) of what the JAX package's
# bonsai_tpu.api returns on the CPU, from the repository root, with EC the
# sorted tests/data/ec/*.fna.gz, RECORDS every (name, seq) of
# bonsai_tpu.io.fastx.read_fastx over EC, K12 the sequence of EC_GENOME's
# first record and FRAMES = [translate(K12, f) for f in range(3)]
# (bonsai_tpu_torch.tools.synthetic, plain numpy):
#   seqdict:  _digest((n, a) for p in EC for n, a in api.seqdict(p, k=31,
#             w=40).items())
#   RECORDS:  _digest((n, api.get_kmers(s, **KW)) for n, s in RECORDS)
#   K-12:     _digest([(None, api.get_kmers(K12, **KW))])
#   protein:  _digest((None, api.get_kmers(f, input_type=IT, **KW)) for f in
#             FRAMES)
#   rolling:  _digest([(None, api.rolling_hashes(K12, k, canonicalize))])
# (JAX_PLATFORMS=cpu, numpy 2.0.2).  The Shannon score's terms
# (bonsai_tpu_torch.core.entropy.shannon_terms(k), numpy's log) made there:
API_TERMS = {
    7: "d16ef9abc1a1483381b91556df7c06370e0317808080a766f27f60a71b110ca5",
    12: "3372e43c750daad9e77c44b43d315898fa783e353175fe4b97a0c3320915ed96",
    13: "3a82e604f1f4006b01df9651fd07dc3665f603fd0e1bac3448b2776892417ea4",
    21: "e689120b557b9f5b12c3e7012383c793482a485a82d097196a7071e8bdfe5d49",
    31: "c2436db6ac477a4ed2ec9601341c30264ed654005ee58d4d032dfcf1bb8ab390",
}
API_DIGESTS = {
    "seqdict -k 31 -w 40":
        "5465ce045d37912662e1b3814108c28ccc4bcbfa0eaac2eb17a8dbb701490641",
    "-k 31 -w 40 entropy":
        "211eeabdf03276932bde847ec9e4b459a6fe49b7707e28cc224beac5ece88901",
    "-k 21 -S 0x16,1x4 -w 40 entropy -C":
        "779f8d9da71b7bdc9076e926245af4f901d03a0736a68b6869876ae653de84ee",
    "K-12 -k 13 -w 29 entropy":
        "13b91a315d68f724185c812baa93e196e121cf6384ced339fbaee555ca331463",
    "K-12 -k 13 -w 29 entropy -C":
        "26e9e1e9bca24d7b1827764e82b84e74586e23e264b04422de940ae63375b2bf",
    "PROTEIN20 -k 7":
        "ffa33e6acf5c19539d35cdb9b555c609a082e46da1354b278edf856136bbc349",
    "PROTEIN20 -k 7 -w 20 entropy":
        "420aca424eff32a6a2c11c39a9c120d2b7f830aec5dc682a08182f297ddfaa90",
    "PROTEIN_14 -k 10 -w 24":
        "9e84858f5689dd185bfeba73ed24ae7d83b2d4f522e3b15711df29453ec9809f",
    "PROTEIN_6 -k 12 -S 1x11 -w 30 entropy":
        "ec5a2354ab17f57b3de02ae16077e68e00eee9e3072ddc3e58e1613f96194b08",
    "PROTEIN -k 8":
        "cd73b8e59789c830c3a397aa9feecac414341b707124b9b9a806eff9eadbf03c",
    "PROTEIN_3BIT -k 22":
        "d39940d9756a37a55977137dfe24a6a975c70dc120b8aa053c8f31c94f43701b",
    "rolling k=31 canonical":
        "141c489a3c3d39ea09600c46408e75d873ee90c153228adc735cd60de272611e",
    "rolling k=64 canonical":
        "a64054a5814b286735163ed6af013e24c41ed944cda5bcbf09e3cadd8b4d92fa",
    "rolling k=200":
        "b3026e42702752c2f7b0790ac8d2ed29eca24459bb87369140bfdbdb3d6fab03",
}
# the protein rows of API_DIGESTS: key, input type name, get_kmers' keywords
API_PROTEIN = [
    ("PROTEIN20 -k 7", "PROTEIN20", dict(k=7)),
    ("PROTEIN20 -k 7 -w 20 entropy", "PROTEIN20",
     dict(k=7, w=20, scheme="entropy")),
    ("PROTEIN_14 -k 10 -w 24", "PROTEIN_14", dict(k=10, w=24)),
    ("PROTEIN_6 -k 12 -S 1x11 -w 30 entropy", "PROTEIN_6",
     dict(k=12, spacing="1x11", w=30, scheme="entropy")),
    ("PROTEIN -k 8", "PROTEIN", dict(k=8)),
    ("PROTEIN_3BIT -k 22", "PROTEIN_3BIT", dict(k=22)),
]

# Phase 9e, the sketch front-ends: the JAX package's values on the CPU
# (JAX_PLATFORMS=cpu, numpy 2.0.2), from the repository root, with EC the
# sorted tests/data/ec/*.fna.gz and run() bonsai_tpu.cli.main in an empty
# directory on the absolute EC paths.  SKETCH_SHS: for each kmercnt mode
# of SKETCH_MODES, the sha256 over EC in order of each genome's .shs
# content (u64 count, sorted keys: the bytes write_shs gzips) from
# bonsai_tpu.sketch.shs.MultiKCounter(ks, canon=, nthash=).add_file(g)
# .counts(), by k, and of the .bin content at k = 31 (u64 count, keys, u16
# counts).
SKETCH_MODES = [  # (kmercnt flags, ks, canonical, ntHash)
    ("-k 17,21,25,29,31", (17, 21, 25, 29, 31), False, False),
    ("-k 17,21,25,29,31 -C", (17, 21, 25, 29, 31), True, False),
    ("-k 21,31 --nthash", (21, 31), False, True),
]
SKETCH_SHS = {
    "-k 17,21,25,29,31 .17.shs":
        "ee629ed35da550679cb0d2fe6638b65e667a0b6bb8fb2fc798f2fc00bf674b56",
    "-k 17,21,25,29,31 .21.shs":
        "89e1116f4e32c1011ac7598f7cd0578b48d06594f55b55c69ffba40bdb28bf48",
    "-k 17,21,25,29,31 .25.shs":
        "ebd0c40a726a359498841ed5b1d197a437779fcfd47ee3795e0ebe85d13d3845",
    "-k 17,21,25,29,31 .29.shs":
        "cdb9c4cf6973ac0fb544612bf2d9e1d4d117f724afe9bc65b01a4d41b4e48061",
    "-k 17,21,25,29,31 .31.shs":
        "5c7faef339bfa0ec2dd2cdcffbab09cee3104f96efad654670fdc26e924d120c",
    "-k 17,21,25,29,31 .31.bin":
        "98c4ef4729f7d9e53babbfe9a360c9057aa09bf0617740c0b9d4b76aeb07f684",
    "-k 17,21,25,29,31 -C .17.shs":
        "c2bacea6b73a2795ce71927afc991dfd2899f1f5d98a072cc62cbafec19d1f83",
    "-k 17,21,25,29,31 -C .21.shs":
        "27846d86ac9f7b4309ce23feab553e606dd1d424059ae2e7d47f4768d1fb2d55",
    "-k 17,21,25,29,31 -C .25.shs":
        "9cbeb6b96bceec34f89d8909b9f2280af3f174c8a703bd4282033cd58894216b",
    "-k 17,21,25,29,31 -C .29.shs":
        "969e38d19b74a719fd9af4dff2d9156adfc959194c1aba1579b09a79af7245cb",
    "-k 17,21,25,29,31 -C .31.shs":
        "08635dbdf1caf6a85575defec04ac7958192e65339e970a64c66dfc932b4fe95",
    "-k 17,21,25,29,31 -C .31.bin":
        "d229d0e2e6bf2eee02f1a09d0dfe3f801621673bf2de7a11ed0da8d681652908",
    "-k 21,31 --nthash .21.shs":
        "2ae49775746d1c616587fa6b94d5699be522814c62e82436dc63bbadebab7efe",
    "-k 21,31 --nthash .31.shs":
        "28172dcfec25b3014924893e7a4b0c0ddffac78dede0bcd5cd63f4753e73f8c3",
    "-k 21,31 --nthash .31.bin":
        "b2208539fe8b7ac0f241876c36884dea0f713712dd14ea36f5c584671e408ed7",
}
# kmercnt -k 31 -C alone seeds its hash with the ladder's first seed pair:
# the same sha256 over EC of MultiKCounter([31], canon=True)'s .shs
SKETCH_SHS_K31 = (
    "b2c9431573f85c52617c1c32ea0bb7c117ccd7fc8c9b3fb3b74832c25e1ae4d1")
# run(["setsketch", *EC, *FLAGS.split(), "-B", "-o", "union.ss"]): for
# each genome's .ss (<basename>.<k>.4096.ss) and the union's, read with
# bonsai_tpu.sketch.setsketch.CSetSketch.read: (n_updates, sha256 of
# ids().tobytes(), of idcounts().tobytes() or None, of the registers'
# bytes, cardinality())
SETSKETCH_MAIN = "-k 31 -z 4096 -S -s"
SKETCH_SETSKETCH = {
    "-k 31 -z 4096 -S -s": [
        (4641622,
         "5be48f85ba6fc9da69f2142cbef2beb7e4115b498d06a88252058d7bba7b502e",
         "f5b9fc0150b342538d5d2088892c161c2621ccd4f9a1ac767a9de5c38f4a49de",
         "bd30422fe352cdfa4816babcfc53f54fe14c6aa8f4ecb50f556337d0cf136d67",
         4727880.3168891445),
        (5225084,
         "f72d8c3ee92fc78a52efa293e0009def11ca95d8367380a9e6a0d07995d71d04",
         "eea50101bcc640b711c7fbdd1772ce68865829042316e526e0ccc45228f25092",
         "9ed1936977a3f3bd67591b5b7b817b7d430cb226ea97eeda0caea2cadeb4693d",
         5140996.951982915),
        (5594387,
         "9f452d0a9b5c1d5300ee406750f18ced2c68d5b6410f2f9de4275ee5eea3d403",
         "96d0149562c78d57fa59a4ed4bb9f8714155c864c773165f63dac0d9af5df277",
         "2e11095199366e4e702853ebe56cdbbe7d3f36a0e95323a86eb11ddf0d58a6ee",
         5365429.261315836),
        (4558917,
         "0acb4e936789fe499790a714a89827ebd27aa7d3021c459f71c1d41c73c5c8cd",
         "af1bb2560cd82b012dea9479f00243ed9a388d331624ceeb85cc7d23ed25f3a7",
         "8b4e57858795d87f01111d849f1b6830be0ad11cdb56bd84c2abd641b31c4786",
         4583412.799409365),
        (4646302,
         "9ba6b07d2cd16e52049cb82c4e7cc732ffe92c6b6f71b727c9afdacb6ed37be8",
         "de8b1f2da9bcdf05b470d713c341a668c9a5c0a10008611459ac572eda2ab704",
         "6bb4aaa840df2cee4a0940c41fde192dfbd61e7b4a805007769e14332dcf5325",
         4730424.212084219),
        (24666312,
         "7ed274a36c27dbcd292411687acde4ebe3b0c37c9afe707d648ceb1495ea34aa",
         "cf660397d0a767fd8f2fd964dba8203f424c2f793ac2a9c9dd3946361703f3d3",
         "234a5cd3e185752dc27372f83fbf96e5731054ad835695b2a1935b0477d9d0f9",
         10413379.746570053),
    ],
    "-c -k 31 -z 4096 -S": [
        (4641622,
         "6593e2b1175c9dfed8da145bd15223ca3c7489bf9b6b6e91424e9f6d0b701c38",
         None,
         "bf8dda932dfc77df0658e060fe0b9c60f51c6c0bbd1ed7b3b510f4f5cc723a13",
         4629316.438179271),
        (5225084,
         "592d7d8e85a173502619d62e7fd7705c158b5ac6c620779546d99e243f93c78a",
         None,
         "5ba4ab10aa4fc9d457ecbbed43a343b83360a652ad4cb020bacb44afa6ce432c",
         5155891.807377332),
        (5594387,
         "79b44846850616ee673a6118d660f822b2a6a53dd533e984b712604f6b53a7ae",
         None,
         "25b961d22d72eb11453946ef95a2cf27c757d80278ddb71d748da8d67fe63776",
         5484892.928202714),
        (4558917,
         "c59e985ade56ba688e200744099f7884f2d19462839a778697371fa4bcc3c785",
         None,
         "048e97495d29e5cf600d18bdb43fee02bae4bb8ddad8ca8d54f66d8cbff494b8",
         4600096.225437393),
        (4646302,
         "c2417a75410f6d5025f2a72d3c8065b1e28ccd1e68557ffb995a899bd4a56a71",
         None,
         "e6946c0cf9b20145329f6e26453f9b9894e5afb33f3c4522bd5f12904a9e94e1",
         4584614.213340168),
        (24666312,
         "1c30b8c4986f90a5ccd7fa00b501da58ee1d2f27ba297ca0430abd4d8c89f260",
         None,
         "7b949271f19f658b717b65705c4f34cb3458cd66eb63fae2254c0b8ba880d686",
         11511772.371924669),
    ],
    "-k 40 -z 4096 -S -s": [
        (4641613,
         "e5aeb7ce2f378f48c9e10a1073c30d52ef407d217a0556a6f1b492d11bf6c4f5",
         "76f2a8b467085ca3af4ed12b1bad832b1631ef60b47cee244de9519aa1daa581",
         "613b50d02b1a4eb754a677bd090498a6721c61d9ec70ecab01f04d0c732ccb3a",
         4561230.065707411),
        (5223612,
         "a22182766a06d1182c57ab5bffdcabfb786b425339dbc087faf6df55ab9b05ab",
         "d3917e38ae9d75a87a4e586c12fcc4fe9514638c88b7de893ee48bac8efc1baf",
         "04b3910098f74f4cdeccc571f05d2f6e98937edc1da8d7b53bf5a08854236a83",
         5114999.541785166),
        (5594360,
         "fb92bf558e5da27fc113ce1b1eb4073962726e0358bbe68aeef2f873fc25bcf2",
         "df4bc3f2891e4cf406228a5b33876c326d27fd3de9f64122ff8cc2dee5717bf9",
         "5b3dfd8f0b3b6ae423be0a189fdb3856e3abe3c83ef8970197e3f71d5ca1fa1b",
         5424327.025444028),
        (4558908,
         "8e94fad0f54706ec322873fa4e35a261b4c803b15180278100d36ef7550e7225",
         "90533c8692d94c6ae83dc14d27e0dcca02fea834a58d48d0c54165f46408309b",
         "7396270012b8a084285b391d72f46a876d97ff530b000affbcd539774be974c2",
         4453907.308878879),
        (4646293,
         "fdc6843654285dcc9816004f03310a514b9d19ed3c4c42d0f48c078dce54300f",
         "1011b6430ecc453c9373ef35b20105e88894f83a973b7bd1fc45a254baeb176d",
         "6fa2cd32ca1fc94fa6bca0d4a47d0482f552f112a13ef89390ca861bec074325",
         4571055.354585414),
        (24664786,
         "7e995c57b16b8abf9ffd0ac35e9945f52c0663ed52f608f734803c620a1bdfa5",
         "bf00595d04ff564eadce2dacfed1f1b1028121958eb5b670901ada55c357da91",
         "dc4fc2a340ec5c3488e21620ab94138f94b7363642917e5b0e7066cc643cc618",
         11903650.449157802),
    ],
}
# run(["distmat", *EC, "-k", "31", "-o", "dm"]): sha256 of
# np.load("dm.npy").tobytes() and of dm.tsv; --hll 14 as each pair's
# HyperLogLog(14).union_estimate gives it (the hll matrix: the jaccard
# estimates of the JAX CLI's formula, float64, over the sketches of
# bonsai_tpu.db.build.genome_kmer_set(g, Spacer(31, 31), True) filled by
# addh; "hll npy": the sha256 of its float32 bytes) and the JAX CLI's
# run(["distmat", *EC, "-k", "31", "-o", "dmh", "--hll", "14"]) matrix
# (np.load("dmh.npy"), float32: merged in place past j = i + 1)
SKETCH_DISTMAT = {
    "npy": "70c1940572c9d32b64c277f60b41917f902f5635b58e618029e44de3636f848f",
    "tsv": "a31b2bb6df0657427727718399f296bff6e75ac2814e680191c08b16d55895e4",
    "hll npy": "3f29bc172339c91c282a85f5e3333edd4976c7df5671e00e6557f2c7dd7329e0",
    "hll": [
        [1.0, 0.2725325504966615, 0.377864710259722, 0.6447175852607362,
         0.9979163829416042],
        [0.2725325504966615, 1.0, 0.2561061530513593, 0.27233823224633835,
         0.2730136555992211],
        [0.377864710259722, 0.2561061530513593, 1.0, 0.3636118442411039,
         0.37854831876816786],
        [0.6447175852607362, 0.27233823224633835, 0.3636118442411039, 1.0,
         0.6451928864404319],
        [0.9979163829416042, 0.2730136555992211, 0.37854831876816786,
         0.6451928864404319, 1.0],
    ],
    "hll JAX CLI": [
        [1.0, 0.27253255248069763, 0.012216858565807343, 0.0, 0.0],
        [0.27253255248069763, 1.0, 0.2561061382293701, 0.0, 0.0],
        [0.012216858565807343, 0.2561061382293701, 1.0, 0.3636118471622467,
         0.25065919756889343],
        [0.0, 0.0, 0.3636118471622467, 1.0, 0.6451928615570068],
        [0.0, 0.0, 0.25065919756889343, 0.6451928615570068, 1.0],
    ],
}
# run(["cmpshs", *NAMES]) in a directory that holds NAMES, the
# <basename>.31.shs of each EC genome written by write_shs(MultiKCounter(
# [31], canon=True).sets()[0]): sha256 of stdout
SKETCH_CMPSHS = "30f35f73a02caa25ae017f2da0a44a8cf3a6f088e74931cd18c3dc2d16d9b653"
# KS4 on the K-12 canonical 31-mers (genome_kmer_set(EC_GENOME, Spacer(31,
# 31), True), SKETCH_K12_KMERS of them): sha256 of the bytes of
# bonsai_tpu.core.hashes.wang_hash, khash_int64_hash,
# bonsai_tpu.core.bitops.popcount64, and bonsai_tpu.util.nuccount,
# gccount, kmer_entropy at k = 31
SKETCH_BITMIX = {
    "wang_hash":
        "8c35f786bad9bbaaf04a777e968b43e4c166e0896734563f3fbb3b3544fe703e",
    "khash_int64_hash":
        "5fcfd50dab3461430df14466fea68e546313ed412c326e1f9d498612c66c9f4b",
    "popcount64":
        "be45c3de75d9cc449cab810c9c433d33fbc6627903beb30e4768ad27aba69355",
    "nuccount":
        "3a4d275f55bc1ae47f8766cc800f69104d0bb60721956d6a25837893a6ddc34a",
    "gccount":
        "8393d95bb82410e6fa81ceda3b5791cf1667cdd6d84ba25254388fe1f75e105c",
    "kmer_entropy":
        "54d9035c6e3b46c8f1e6a595a7ae018d28cafec4d26a4a9fd112f8bb6437651e",
}
SKETCH_K12_KMERS = 4554269
# KS4's inverse mixes and rotates on the same K-12 31-mers: sha256 of the
# bytes of bonsai_tpu.core.hashes.frev64_inv, wang_hash_inv, lrot(x, 31)
# and rrot(x, 17) on the CPU
SKETCH_INVERSES = {
    "frev64_inv":
        "8dc994f05edd2fd9e37221bbae7ff01f31f12e431cb3eeccb0f74e479a0a9942",
    "wang_hash_inv":
        "0df9f65fc261d6deec1fae961fea4eb324c819b766d98943e27d084032731dff",
    "lrot 31":
        "a08a98b7c4a32d8aabde527bf2ee6b23aaeb5b5defb9fe6ed72a12cf094bf62f",
    "rrot 17":
        "a1eaaa43eac71c7c897b3fa42bee2dd18fd112645aa1da05c932aa4d612ef614",
}
# run(["rolling-multk", *EC]) and run(["rolling-multk-sketch", *EC, "-z",
# "1024"]): sha256 of stdout with EC's directory cut from each path, and
# the second's cardinalities at full precision, in its order: per genome
# and k, CSetSketch(1024) updated with MultiKCounter(ks).sets()[k]
SKETCH_ROLLING = {
    "rolling-multk":
        "b9badf7e132a2c1f2f90e618858bfe019fe123c8fc3685c5dae8a7e3f7fc9a67",
    "rolling-multk-sketch text":
        "734a2241ad61a77beb825d6bb9263d2cbe49e12ff2cb9b61775ccee5330717e1",
}
SKETCH_ROLLING_CARDS = [
    4648208.858854608,
    4460571.689242506,
    4593036.347497373,
    4323321.9643374365,
    4784726.872918068,
    5319055.3013883345,
    4937107.674235418,
    5152624.737206378,
    5176667.415864505,
    5031286.157569116,
    5424514.9819536805,
    5278501.317654016,
    5353870.829242158,
    5468831.528073519,
    5335974.311709376,
    4677844.230066695,
    4327956.1303931745,
    4521951.649775854,
    4393705.523307537,
    4474310.96844034,
    4681808.110663155,
    4448130.549473611,
    4569399.281669311,
    4341651.807644334,
    4658728.609468935,
]


# Phase 9f, database formats: the ec k=31 database (EC_DB below) as the JAX
# package's CLI writes it, from the repository root, with EC the 5 genomes
# of the golden manifest's "kraken" entry in its order and G =
# tests/data/golden (JAX_PLATFORMS=cpu, numpy 2.0.2):
#   python -m bonsai_tpu build OUT EC -k 31 -T G/ec_nodes.dmp -M
#     G/ec_nameidmap.txt FLAGS
# FLAGS -> {file of the directory OUT: sha256}; --bonsai-format: the file's
EC_DB_CMD = ("python -m bonsai_tpu build OUT <ec genomes> -k 31 -T "
             "tests/data/golden/ec_nodes.dmp -M tests/data/golden/"
             "ec_nameidmap.txt FLAGS")
FORMAT_SHARDS = {
    "--shards 4": {
        "manifest.json":
            "7c0f550123b9398619c5f8b6b8b7348875a8b4e2c83711ebe89db758e0c48c77",
        "shard-00000.btpu":
            "e26d6aa8d0032369dbe2615fdc2d7daae9da31f8c6ef9491b4bc8b3105ad1a14",
        "shard-00001.btpu":
            "f2cbac1a785eae48531680e8cfec95a1d0bab74d78b8058e28714d26940a5f11",
        "shard-00002.btpu":
            "1b055ebacbda82f5086f3654671c697e9db144ee7c03b9112eb622f1a487de9a",
        "shard-00003.btpu":
            "611cdd436cac9892fae307df436cd6566b0e7a96da218c309a092d89b3d033a2",
        "uniq_vals.npy":
            "d0a599e002c4de0bfb4320e36092b10810e28780272ebdbfe75a11dff093efb7",
    },
    "--shards auto": {  # "--shards auto -> 1"; its shard is the .btpu file
        "manifest.json":
            "26863d4ed35aa41377f2313b4e286c0432a890d82a39d774f6beb1b48fa2597b",
        "shard-00000.btpu":
            "a885bcd5136698e8b6de5656332db5d19af5eb89111685f348947b80c56af6fb",
        "uniq_vals.npy":
            "d0a599e002c4de0bfb4320e36092b10810e28780272ebdbfe75a11dff093efb7",
    },
}
FORMAT_KHASH = \
    "ce6fbf79cf4bef6cd3d1b272df9a52983b0e48e5e24dac0b31ba23406ded1c39"
# sha256 of bonsai_tpu.db.table.shard_owner(keys, ndb).tobytes() (int32)
# over the keys of that database (bonsai_tpu.db.formats
# .read_database_arrays of its .btpu file)
FORMAT_OWNERS = {
    1: "84e14896c79276e5c8bd589525dced8097987e1a849cd36d91f39eab75d33f82",
    3: "53e5326547c96b2ac38cda8d210beedaeea62180aac2591617b70c6437e7bd46",
    4: "9fe167ab9c158ba743f402616162808aab8f0784faefa8051b2fd0cd9a4ccbcb",
    65536: "8886c37e260f72feb37f618d90120583a3510d6449ba89d499af4aaf1459ab99",
}
# 128-bit k-mers of K-12 (CODES = bonsai_tpu.io.fastx.encode_contig(the
# first record of EC_GENOME, DNA4.lut)[None, :]): sha256 of the bytes of
# (hi, lo, invalid) = bonsai_tpu.core.encode128.pack_kmers128(CODES, k), of
# reverse_complement128(hi, lo, k) and of (canonical128(hi, lo, k),
# invalid), each array's bytes in turn
K128_DIGESTS = {
    33: ("770fc43d43d4cc765d60d0931dcc084c12629849c2f38f9d2b71aa64ca72e798",
         "d0e493dbf301de547f0c00743ecbd73b49cd3daa634eadacedf3103ab5909419",
         "4c08f5b519f644b443f8fc0698de7e4de0797c069891d94cd6ff4611df7f8f77"),
    40: ("2d6a051427613c897ce031a54eab40444b6232cb56f2eca3e06becc13ae24b82",
         "2398902a2c3053eec0a5f688459cb95b1beee08b8b76368169c521fae2523c1d",
         "ae24de3fcabe40cdaca658f2b7977fcf8b8cadf6ffe741b6aaab9f4e67f9da40"),
    55: ("ea99a703259a11adfcc661d3a86f513e558be4f132d7b44b0b806c71fcbf7801",
         "4e6733623fafe416134c84b65acedd7b6cb41c4029036e3683f89580da75cc83",
         "76158eee8603239bc124f6c5ad27335041d073b84077ec80d4f7008014241949"),
    64: ("058c511612f10f041c76abdec53070ff40f93a57236e4508a8ba8dfb5720e96f",
         "4fe006db151e43770256b8af09a3e6abc20e44ffbb1c457a7469c9fa57cc56b7",
         "576120cd0ed649aa2900613c84d722e33d7e516f3f458395146efec4e07e935b"),
}
# windowed rolling minimizers of K-12: (values, mask) = bonsai_tpu.core
# .rolling.RollingEncoder(k, canon, w).emissions(CODES, [len]), sha256 of
# the bytes of values[mask] then mask, and the emitted count
EMISSION_DIGESTS = {
    (31, 40, True): (
        "5e24a52f8010df9f61c3bb57b29e5cae33a35c0c6878496c8bce59d2a580d076",
        4641613),
    (64, 100, False): (
        "48ac09049edb645fdcabb0722dca2699935567e88162c1f82735564a100a98c0",
        4641553),
}


# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "encode_probe": ("bonsai_tpu_torch/csrc/encode_probe.cu",
                     "bonsai_tpu/db/table.py:370"),
    "resolve": ("bonsai_tpu_torch/csrc/resolve.cu",
                "bonsai_tpu/classify/resolve.py:57"),
    "step_outputs": ("bonsai_tpu_torch/csrc/step_outputs.cu",
                     "bonsai_tpu/classify/pipeline.py:124"),
    "minimizers": ("bonsai_tpu_torch/csrc/minimizers.cu",
                   "bonsai_tpu/core/encoder.py:174"),
    "minimizers_spaced": ("bonsai_tpu_torch/csrc/minimizers.cu",
                          "bonsai_tpu/core/encode.py:108"),
    "minimizers_entropy": ("bonsai_tpu_torch/csrc/minimizers.cu",
                           "bonsai_tpu/core/entropy.py:91"),
    "compacted_minimizers": ("bonsai_tpu_torch/csrc/compacted_minimizers.cu",
                             "bonsai_tpu/core/minimize.py:109"),
    "sort_unique": ("bonsai_tpu_torch/csrc/sort_unique.cu",
                    "bonsai_tpu/db/build_device.py:192"),
    "merge_fold": ("bonsai_tpu_torch/csrc/merge_fold.cu",
                   "bonsai_tpu/db/build_device.py:145"),
    "row_gather": ("bonsai_tpu_torch/csrc/gather_bench.cu",
                   "tools/probe_microbench.py:225"),
    "take_along": ("bonsai_tpu_torch/csrc/gather_bench.cu",
                   "tools/vmem_gather_bench2.py:35"),
    "encode_probe_spaced": ("bonsai_tpu_torch/csrc/encode_probe.cu",
                            "bonsai_tpu/core/encode.py:59"),
    "minimizers_hash": ("bonsai_tpu_torch/csrc/minimizers.cu",
                        "bonsai_tpu/core/encoder.py:105"),
    "minimizers_spaced_hash": ("bonsai_tpu_torch/csrc/minimizers.cu",
                               "bonsai_tpu/core/encoder.py:189"),
    "compacted_minimizers_hash": (
        "bonsai_tpu_torch/csrc/compacted_minimizers.cu",
        "bonsai_tpu/core/encoder.py:206"),
    "lookup_scores": ("bonsai_tpu_torch/csrc/lookup_scores.cu",
                      "bonsai_tpu/db/table.py:501"),
    "minimizers_spaced_shannon": ("bonsai_tpu_torch/csrc/minimizers.cu",
                                  "bonsai_tpu/core/entropy.py:67"),
    "minimizers_radix": ("bonsai_tpu_torch/csrc/minimizers.cu",
                         "bonsai_tpu/core/encode.py:135"),
    "minimizers_radix_shannon": ("bonsai_tpu_torch/csrc/minimizers.cu",
                                 "bonsai_tpu/core/entropy.py:82"),
    "compacted_minimizers_shannon": (
        "bonsai_tpu_torch/csrc/compacted_minimizers.cu",
        "bonsai_tpu/core/entropy.py:47"),
    "compacted_minimizers_radix": (
        "bonsai_tpu_torch/csrc/compacted_minimizers.cu",
        "bonsai_tpu/core/encode.py:163"),
    "compacted_minimizers_radix_shannon": (
        "bonsai_tpu_torch/csrc/compacted_minimizers.cu",
        "bonsai_tpu/core/encoder.py:118"),
    "cyclic_hashes": ("bonsai_tpu_torch/csrc/rolling.cu",
                      "bonsai_tpu/core/rolling.py:91"),
    "hll_fill": ("bonsai_tpu_torch/csrc/hll.cu",
                 "bonsai_tpu/sketch/hll.py:37"),
    "csetsketch_update": ("bonsai_tpu_torch/csrc/setsketch.cu",
                          "bonsai_tpu/sketch/setsketch.py:86"),
    "sort_count": ("bonsai_tpu_torch/csrc/sort_unique.cu",
                   "bonsai_tpu/sketch/shs.py:48"),
    "bitmix": ("bonsai_tpu_torch/csrc/bitmix.cu",
               "bonsai_tpu/core/hashes.py:58"),
    "nuccount": ("bonsai_tpu_torch/csrc/bitmix.cu",
                 "bonsai_tpu/core/bitops.py:69"),
    "shard_owner": ("bonsai_tpu_torch/csrc/bitmix.cu",
                    "bonsai_tpu/db/table.py:413"),
    "pack_kmers128": ("bonsai_tpu_torch/csrc/encode128.cu",
                      "bonsai_tpu/core/encode128.py:25"),
    "reverse_complement128": ("bonsai_tpu_torch/csrc/encode128.cu",
                              "bonsai_tpu/core/encode128.py:72"),
    "canonical128": ("bonsai_tpu_torch/csrc/encode128.cu",
                     "bonsai_tpu/core/encode128.py:92"),
    "compacted_stream": ("bonsai_tpu_torch/csrc/compacted_minimizers.cu",
                         "bonsai_tpu/core/rolling.py:174"),
    "route_frame": ("bonsai_tpu_torch/csrc/route.cu",
                    "bonsai_tpu/parallel/sharded.py:288"),
    "route_probe": ("bonsai_tpu_torch/csrc/route.cu",
                    "bonsai_tpu/parallel/sharded.py:356"),
    "route_collect": ("bonsai_tpu_torch/csrc/route.cu",
                      "bonsai_tpu/parallel/sharded.py:378"),
    "encode_only": ("bonsai_tpu_torch/csrc/encode_probe.cu",
                    "bonsai_tpu/parallel/sharded.py:405"),
    "encode_probe_range": ("bonsai_tpu_torch/csrc/encode_probe.cu",
                           "bonsai_tpu/parallel/sharded.py:466"),
    "minimizers_sp": ("bonsai_tpu_torch/csrc/minimizers.cu",
                      "bonsai_tpu/parallel/sharded.py:1255"),
    "key_range": ("bonsai_tpu_torch/csrc/bitmix.cu",
                  "bonsai_tpu/db/build_device.py:568"),
    "encode_probe_sparse": ("bonsai_tpu_torch/csrc/encode_probe.cu",
                            "bonsai_tpu/classify/pipeline.py:508"),
    "frev64_inv": ("bonsai_tpu_torch/csrc/bitmix.cu",
                   "bonsai_tpu/core/hashes.py:48"),
    "wang_hash_inv": ("bonsai_tpu_torch/csrc/bitmix.cu",
                      "bonsai_tpu/core/hashes.py:96"),
    "rotl": ("bonsai_tpu_torch/csrc/bitmix.cu",
             "bonsai_tpu/core/hashes.py:123"),
}
# the rows of the sharded classifier and build (phase 9g): instantiations
# of shared wrappers that only phase 9g launches
SHARDED_ROWS = ("encode_only", "encode_probe_range", "minimizers_sp")
# the rows of the hash-scored phase 2 (phase 9c)
HASH_ROWS = ("minimizers_hash", "minimizers_spaced_hash",
             "compacted_minimizers_hash", "lookup_scores")
# the rows of the Python API (phase 9d)
API_ROWS = ("minimizers_spaced_shannon", "minimizers_radix",
            "minimizers_radix_shannon", "compacted_minimizers_shannon",
            "compacted_minimizers_radix", "compacted_minimizers_radix_shannon",
            "cyclic_hashes")
# the variants of one wrapper's launch counts (its ``variants`` dict) that
# each kernel row counts
VARIANTS = {
    "minimizers": ("minimizers", ("lex",)),
    "minimizers_spaced": ("minimizers", ("spaced", "spaced entropy-file")),
    "minimizers_entropy": ("minimizers", ("contiguous entropy-file",)),
    "minimizers_hash": ("minimizers", ("hash",)),
    "minimizers_spaced_hash": ("minimizers", ("spaced hash",)),
    "compacted_minimizers": ("compacted_minimizers", ("lex", "entropy-file")),
    "compacted_minimizers_hash": ("compacted_minimizers", ("hash",)),
    "minimizers_spaced_shannon": ("minimizers", ("spaced shannon",)),
    "minimizers_radix": ("minimizers", ("radix", "radix entropy-file")),
    "minimizers_radix_shannon": ("minimizers", ("radix shannon",)),
    "compacted_minimizers_shannon": ("compacted_minimizers", ("shannon",)),
    "compacted_minimizers_radix": ("compacted_minimizers", (
        "radix lex", "radix entropy-file")),
    "compacted_minimizers_radix_shannon": ("compacted_minimizers",
                                           ("radix shannon",)),
    "encode_probe": ("encode_probe", ("contiguous",)),
    "encode_probe_sparse": ("encode_probe", ("sparse",)),
    "encode_probe_spaced": ("encode_probe", ("spaced", "spaced sparse")),
    "encode_only": ("encode_probe", ("encode", "spaced encode")),
    "encode_probe_range": ("encode_probe", ("range", "spaced range")),
    "minimizers_sp": ("minimizers", ("sequence-parallel",)),
    "reverse_complement128": ("rc128", ("rc",)),
    "canonical128": ("rc128", ("canonical",)),
    "bitmix": ("bitmix", ("wang_hash", "khash_int64_hash", "popcount64")),
    "frev64_inv": ("bitmix", ("frev64_inv",)),
    "wang_hash_inv": ("bitmix", ("wang_hash_inv",)),
    "rotl": ("bitmix", ("rotl",)),
}


def reset_counts(wrappers):
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "variants"):
            w.variants = {}


def read_counts(wrappers, sharded: bool = False):
    """{kernel row: launches} of these wrappers since ``reset_counts``
    (the rows of phase 9g where ``sharded``)."""
    out = {}
    for w in wrappers:
        rows = [r for r, (fn, _) in VARIANTS.items() if fn == w.__name__
                and (sharded or r not in SHARDED_ROWS)]
        for r in rows:
            out[r] = sum(w.variants.get(v, 0) for v in VARIANTS[r][1])
        if not rows:
            out[w.__name__] = w.launches
    return out


def say(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECS = {}  # wall seconds of each phase of main, in order


def phase(name, fn, *args):
    """fn(*args), its wall seconds kept under ``name`` and printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECS[name] = time.perf_counter() - t0
    say(f"# phase {name}: {PHASE_SECS[name]:.1f}s")
    return out


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"# device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return torch.device("cuda", 0), card


def phase_build():
    from bonsai_tpu_torch import kernels, native

    secs = kernels.build()
    kernels.get_lib()
    t0 = time.perf_counter()
    native.get_lib()
    say(f"# build: kernels {secs:.1f}s (nvcc sm_90a), host library "
        f"{time.perf_counter() - t0:.1f}s")


class KernelCheck:
    """Exact comparisons of each kernel with its plain version."""

    def __init__(self):
        self.max_err = {k: 0 for k in KERNELS}
        self.cases = {k: 0 for k in self.max_err}

    def same(self, name, got, want, what):
        import torch

        got = [g.cpu() for g in got]
        for g, w, i in zip(got, want, range(len(want))):
            require(g.shape == w.shape and g.dtype == w.dtype,
                    f"{name} {what} output {i}: {g.shape}/{g.dtype} vs "
                    f"{w.shape}/{w.dtype}")
            if g.numel():
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                self.max_err[name] = max(self.max_err[name], err)
            require(torch.equal(g, w), f"{name} {what}: output {i} differs "
                    "from the plain version")
        self.cases[name] += 1


def _batch(path, n, lut):
    from bonsai_tpu_torch.io import fastx

    return next(iter(fastx.batch_reads(path, lut, batch_size=n)))


def _cpu(t):
    return None if t is None else t.cpu()


def _to(t, dev):
    return None if t is None else t.to(dev)


def _mask_only(clf):
    """``clf`` with its hook ``_sparse_n_ok`` returning False (as the
    sharded classifier's does): the same arrays, the N mask whenever a
    batch holds an in-read N."""
    import copy

    class MaskOnly(type(clf)):
        def _sparse_n_ok(self):
            return False

    m = copy.copy(clf)
    m.__class__ = MaskOnly
    return m


def _channels(clf, fn):
    """fn(), with the N channel of each batch that ``clf`` packed in it,
    in order: (fn's result, the channels)."""
    seen = []
    prepare = clf._prepare_batch

    def spy(*args, **kw):
        prep = prepare(*args, **kw)
        seen.append(prep.channel)
        return prep

    clf._prepare_batch = spy
    try:
        return fn(), seen
    finally:
        del clf._prepare_batch


def _k1_prep(prep, dev):
    """(pcodes, nmask, lengths) of a prep on ``dev`` (None for CPU), and
    its sparse list: K1's inputs."""
    t = (lambda x: x) if dev is None else (lambda x: _to(x, dev))
    return (t(prep.pcodes), t(prep.nmask), t(prep.lengths)), t(prep.nidx)


def phase_kernels(dev, clf, lut, deep):
    """K1, K2, K3 on the card vs their plain versions on CPU copies."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.classify import resolve as rs
    from bonsai_tpu_torch.db.table import ProbeArrays

    chk = KernelCheck()
    rng = np.random.default_rng(SEED)
    arr_cpu = ProbeArrays(clf.arr.slots.cpu(), clf.arr.vals.cpu(),
                          clf.arr.inline, clf.arr.lgnb, clf.arr.vbits)
    tax_cpu = {k: v.cpu() for k, v in clf.tax.items()}
    dict_size = len(clf._uniq_host)

    def k1(batch, tag, paired=False):
        """K1 in the batch's channel against its plain version; a sparse
        batch also against K1's mask instantiation on the same reads."""
        prep = clf._prepare_batch(batch, paired)
        args = (prep.lproc, clf.k, clf.canon)
        (pc, nm, ln), nidx = _k1_prep(prep, dev)
        got = pl.encode_probe(pc, nm, ln, *args, clf.arr, True, nidx=nidx)
        (pc, nm, ln), nidx = _k1_prep(prep, None)
        want = pl.encode_probe_plain(pc, nm, ln, *args, arr_cpu, True,
                                     nidx=nidx)
        sparse = prep.channel == "sparse"
        name = "encode_probe_sparse" if sparse else "encode_probe"
        chk.same(name, got, want, f"{tag} ({prep.channel})")
        if sparse:
            mp = _mask_only(clf)._prepare_batch(batch, paired)
            require(mp.channel == "mask", f"{tag}: the mask channel")
            (pc, nm, ln), _ = _k1_prep(mp, dev)
            chk.same(name, got, [m.cpu() for m in pl.encode_probe(
                pc, nm, ln, *args, clf.arr, True)], f"{tag}: = K1 mask")
        return got, prep.channel

    def k2_k3(k1_out, tag, paired=False, maxr=8, dsizes=(dict_size,)):
        hit, valid, cidx, oidx = k1_out
        valid1 = valid.sum(-1, dtype=torch.int32)
        if paired:
            B, P = hit.shape
            hit, valid = hit.view(B // 2, 2 * P), valid.view(B // 2, 2 * P)
            cidx, oidx = cidx.view(B // 2, 2 * P), oidx.view(B // 2, 2 * P)
            valid1 = valid1[0::2].contiguous()
        taxon = rs.resolve(cidx, hit, clf.tax, clf._n_distinct)
        for nd in (clf._n_distinct, None):
            want = rs.resolve_plain(cidx.cpu(), hit.cpu(), tax_cpu, nd)
            chk.same("resolve", [taxon], [want], f"{tag} n_distinct={nd}")
        for ds in dsizes:
            got = pl.step_outputs(taxon, oidx, hit, valid, valid1, maxr, ds)
            want = pl.build_step_outputs(taxon.cpu(), oidx.cpu(), hit.cpu(),
                                         valid.cpu(), valid1.cpu(), maxr, ds)
            chk.same("step_outputs", got, want, f"{tag} dict_size={ds}")

    hiseq = os.path.join(DATA, "kraken_benchmarks", "HiSeq_accuracy.fa")
    b = _batch(hiseq, 8192, lut)
    out, channel = k1(b, "HiSeq 8192")
    require(channel == "sparse", f"HiSeq 8192 took {channel}")
    k2_k3(out, "HiSeq 8192", dsizes=(dict_size, 200, 4000, None))
    # the sparse list exactly cap = 256 long (no sentinel), its Ns at
    # column 0, at len - 1 and at 16- and 32-base word edges
    codes, lengths = b.codes.copy(), b.lengths.copy()
    inread = np.arange(codes.shape[1])[None, :] < lengths[:, None]
    codes[(codes < 0) & inread] = 1
    pick = [r * codes.shape[1] + c for r, c in (
        (0, 0), (1, int(lengths[1]) - 1), (2, 15), (2, 16), (3, 31), (3, 32))]
    pick += list(np.random.default_rng(SEED + 13).choice(
        np.setdiff1d(np.flatnonzero(inread), pick), 256 - len(pick),
        replace=False))
    codes.reshape(-1)[pick] = -1
    b3 = type(b)(names=b.names, seqs=b.seqs, codes=codes, lengths=lengths,
                 quals=b.quals)
    require(int((clf._prepare_batch(b3).nidx.numpy().view(np.uint32)
                 != pl.N_SENTINEL).sum()) == 256, "the list is not cap long")
    out, channel = k1(b3, "HiSeq 8192, 256 Ns")
    require(channel == "sparse", f"HiSeq 8192 with 256 Ns took {channel}")
    k2_k3(out, "HiSeq 8192, 256 Ns")
    # reads shorter than k, and extra in-read Ns
    codes = b.codes.copy()
    lengths = b.lengths.copy()
    short = rng.choice(len(lengths), 512, replace=False)
    lengths[short] = rng.integers(1, clf.k, size=short.size)
    codes[np.arange(codes.shape[1])[None, :] >= lengths[:, None]] = -1
    rows = rng.integers(0, len(lengths), 2000)
    codes[rows, rng.integers(0, 101, rows.size)] = -1
    b2 = type(b)(names=b.names, seqs=b.seqs, codes=codes, lengths=lengths,
                 quals=b.quals)
    out, _ = k1(b2, "HiSeq short+N")
    require(bool((out[1].sum(-1)[torch.from_numpy(short).to(dev)] == 0).all()),
            "a read shorter than k has a valid position")
    k2_k3(out, "HiSeq short+N")
    # paired rows (mates 2i, 2i+1), W = 2P
    out, _ = k1(b, "HiSeq paired", paired=True)
    k2_k3(out, "HiSeq paired", paired=True, dsizes=(dict_size, None))
    # MiSeq: longer reads, W > 255 in pairs
    miseq = os.path.join(DATA, "kraken_benchmarks", "MiSeq_accuracy.fa")
    out, _ = k1(_batch(miseq, 4096, lut), "MiSeq 4096", paired=True)
    k2_k3(out, "MiSeq paired", paired=True, dsizes=(dict_size, None))
    # long reads, P > 1024: resolve's block-per-read kernel (and the
    # dedup/blockwise branches of its plain version)
    from bonsai_tpu_torch.tools.synthetic import long_reads

    out, _ = k1(long_reads(EC_GENOME, lut, rng), "long reads")
    require(out[0].shape[1] > 1024, "long-read batch has P <= 1024")
    k2_k3(out, "long reads", dsizes=(dict_size, None))
    # run overflow (n_runs > maxr) and the wide layout (W >= 2^15)
    for R, W in ((256, 200), (4, 1 << 15)):
        hit = torch.from_numpy(rng.random((R, W)) < 0.7).to(dev)
        valid = hit | torch.from_numpy(rng.random((R, W)) < 0.5).to(dev)
        taxa = torch.from_numpy(rng.integers(0, 6, (R, W)).astype(np.int32)).to(dev)
        taxa = torch.where(hit, taxa, 0)
        taxon = torch.from_numpy(rng.integers(0, 2**31, R).astype(np.int32)).to(dev)
        valid1 = valid[:, : W // 2].sum(-1, dtype=torch.int32)
        for ds in (6, None):
            got = pl.step_outputs(taxon, taxa, hit, valid, valid1, 8, ds)
            want = pl.build_step_outputs(taxon.cpu(), taxa.cpu(), hit.cpu(),
                                         valid.cpu(), valid1.cpu(), 8, ds)
            chk.same("step_outputs", got, want, f"overflow R={R} W={W} ds={ds}")
    resolve_edges(dev, chk, clf, deep)
    torch.cuda.synchronize()
    say(f"# kernels: all equal to their plain versions: {chk.cases} cases")
    return chk


def resolve_edges(dev, chk, clf, deep):
    """K2 against resolve_plain where the read batches do not reach: a
    taxonomy with a parent cycle under both tie rules, the deep tree
    (n_distinct given and None; the dedup branch through both kernels),
    rows of 0, 1 and 2 hits and rows whose hits all fall on one taxon,
    at a width of the warp-per-read kernel and one of the block-per-read
    kernel."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.classify import resolve as rs
    from bonsai_tpu_torch.taxonomy.tree import TaxTree
    from bonsai_tpu_torch.tools.synthetic import deep_rows

    rng = np.random.default_rng(SEED + 4)

    def k2(cidx, hit, tree, nd, tag):
        c, h = torch.from_numpy(cidx), torch.from_numpy(hit)
        got = rs.resolve(c.to(dev), h.to(dev), tree.device_arrays(dev), nd)
        chk.same("resolve", [got], [rs.resolve_plain(
            c, h, tree.device_arrays("cpu"), nd)], f"{tag} n_distinct={nd}")
        return got.cpu().numpy().view(np.uint32)

    def pool_rows(pool, R, W, p_hit=0.6):
        hit = rng.random((R, W)) < p_hit
        return np.where(hit, rng.choice(pool, (R, W)), 0).astype(np.int32), hit

    # a parent cycle (5 <-> 6): its nodes keep tin = 0, the root's tin; the
    # JAX package answers taxid 6 (first position) in its dense branch and
    # taxid 1 (smaller compact index) in its dedup branch
    cyc = TaxTree({1: 0, 2: 1, 3: 1, 5: 6, 6: 5})
    for P in (300, 74):
        cidx, hit = pool_rows(cyc.compact([1, 5, 6]), 64, P)
        cidx[0], hit[0] = 0, False
        cidx[0, 0], hit[0, 0] = cyc.compact([6])[0], True
        cidx[0, 1:150], hit[0, 1:150] = cyc.compact([1])[0], True
        for nd in (3, None):
            got = k2(cidx, hit, cyc, nd, f"parent cycle P={P}")
            want = 1 if rs.dedup_rule(nd, P) else 6
            require(int(got[0]) == want, f"resolve: parent cycle P={P} "
                    f"n_distinct={nd}: taxid {got[0]}, the JAX package's {want}")
    # the deep tree: two deep taxa tied in every read; the dedup branch
    # at a warp kernel's and a block kernel's width
    cidx, hit = deep_rows(rng, deep)
    for nd in (int(np.unique(cidx[hit]).size), None):
        k2(cidx, hit, deep, nd, "deep tree")
    pool = rng.choice(np.arange(1, deep.tin.size), 100, replace=False)
    for R, W in ((512, 300), (64, 1500)):
        k2(*pool_rows(pool, R, W), deep, 100, f"deep tree, 100 taxa, W={W}")
    # rows of 0, 1 and 2 hits and rows all on one taxon, on the ec tree
    pool = np.arange(1, min(clf.tax["tin"].shape[0], 7))
    for W in (74, 1500):
        cidx, hit = np.zeros((64, W), np.int32), np.zeros((64, W), bool)
        for r in range(16, 48):
            pos = rng.choice(W, 1 + (r >= 32), replace=False)
            hit[r, pos], cidx[r, pos] = True, rng.choice(pool, pos.size)
        hit[48:] = True
        cidx[48:] = rng.choice(pool, (16, 1))
        for nd in (pool.size, None):
            k2(cidx, hit, clf.tree, nd, f"h = 0, 1, 2 and one taxon, W={W}")


def build_ec(tree_path, kk):
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.db.build import content_digest, lca_map
    from bonsai_tpu_torch.db.formats import Database
    from bonsai_tpu_torch.taxonomy.tree import TaxTree

    t0 = time.perf_counter()
    tree = TaxTree.from_nodes_dmp(tree_path)
    genomes = [os.path.join(DATA, "ec", g) for g in kk["genomes"]]
    table = lca_map(genomes, tree, os.path.join(GOLD, kk["nameid"]),
                    Spacer(kk["k"], kk["k"]))
    secs = time.perf_counter() - t0
    digest = content_digest(table)
    say(f"# database: ec k={kk['k']}: {table.n} k-mers, nb=2^{table.lgnb} "
        f"({table.nb * 32 / 2**20:.0f} MiB of slots), built on the host in "
        f"{secs:.3f}s = {table.n / secs:.6g} k-mers/s")
    db = Database(table=table, k=kk["k"], w=kk["k"], gaps=[0] * (kk["k"] - 1))
    return db, tree, digest, secs


def phase_main_path(clf, kk, dev):
    import torch

    from bonsai_tpu_torch import cli
    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.classify import resolve as rs

    wrappers = [pl.encode_probe, rs.resolve, pl.step_outputs]
    reset_counts(wrappers)
    for bs in (8192, 4096):  # the stream's batch, then the CLI's -c
        for which in ("HiSeq", "MiSeq", "ec_k12"):
            s = kk["sets"][which]
            out = io.StringIO()
            t0 = time.perf_counter()
            _, channels = _channels(clf, lambda: clf.process_dataset(
                os.path.join(DATA, s["reads"]), out, batch_size=bs))
            got = hashlib.sha256(out.getvalue().encode()).hexdigest()
            say(f"# main path: {which}, batches of {bs}: "
                f"{out.getvalue().count(chr(10))} lines in "
                f"{time.perf_counter() - t0:.2f}s, sha256 "
                f"{'matches' if got == s['sha256'] else 'DIFFERS'}; N "
                f"channels {channels} (the JAX package's "
                f"{SET_CHANNELS[bs][which]})")
            require(got == s["sha256"],
                    f"{which}: output differs from the golden")
            require(channels == SET_CHANNELS[bs][which],
                    f"{which}: N channels {channels}, the JAX package's "
                    f"{SET_CHANNELS[bs][which]}")
    # paired golden through the CLI: build lex_k25 with the port, classify
    m = json.load(open(os.path.join(GOLD, "manifest.json")))
    cfg = next(c for c in m["configs"] if c["name"] == m["classify"]["db"])
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        dbp = os.path.join(tmp, "lex.btpu")
        genomes = [os.path.join(GOLD, f) for f in
                   ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]
        rc = cli.main(["build", dbp, *genomes, *cfg["flags"], "-T",
                       os.path.join(GOLD, "nodes.dmp"), "-M",
                       os.path.join(GOLD, "nameidmap.txt")])
        require(rc == 0, "port CLI build of lex_k25 failed")
        outp = os.path.join(tmp, "pe.tsv")
        rc = cli.main(["classify", dbp, os.path.join(GOLD, "nodes.dmp"),
                       os.path.join(GOLD, "mate1.fa"),
                       os.path.join(GOLD, "mate2.fa"), "-a", "--device",
                       str(dev), "-o", outp])
        require(rc == 0, "port CLI paired classify failed")
        with gzip.open(os.path.join(GOLD, "classify_pe.tsv.gz"), "rb") as fh:
            want = fh.read()
        with open(outp, "rb") as fh:
            require(fh.read() == want, "paired output differs from the golden")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    launches.pop("encode_probe_spaced")  # the spaced path is phase 5b's
    say(f"# main path: paired golden matches; kernel launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the main path")
    return launches


def phase_scale(dev, lgn=26):
    """K1 against a MiniKraken-class table: 2^lgn keys, 6 values."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.db.table import (KmerTable, ProbeArrays, probe_np,
                                           unique_u64)

    rng = np.random.default_rng(SEED + 1)
    n = 1 << lgn
    t0 = time.perf_counter()
    keys = unique_u64(rng.integers(0, 2**64, size=n + n // 64,
                                   dtype=np.uint64))[:n]
    v = rng.integers(0, 6, size=n).astype(np.uint64)
    vals = ((v + np.uint64(100)) << np.uint64(32)) | v  # 6 distinct values
    table = KmerTable(keys, vals)
    slots, uvals, inline = table.arrays_np()
    t_place = time.perf_counter() - t0
    arr = ProbeArrays.from_numpy(slots, uvals, inline, table.lgnb,
                                 table.vbits, dev)
    del table
    Q = 1 << 23
    q = np.concatenate([keys[rng.integers(0, n, Q // 2)],
                        rng.integers(0, 2**64, Q // 2, dtype=np.uint64)])
    # each query is a 32-base read whose one k-mer (k = 32, not
    # canonicalized) is the query itself: first base in the high bits
    shifts = np.uint64(2) * (np.uint64(31) - np.arange(32, dtype=np.uint64))
    codes = ((q[:, None] >> shifts) & np.uint64(3)).astype(np.uint32)
    words = (codes.reshape(Q, 2, 16) << (np.arange(16, dtype=np.uint32) * 2)
             ).sum(-1, dtype=np.uint32)
    pc = torch.from_numpy(words.view(np.int32)).to(dev)
    ln = torch.full((Q,), 32, dtype=torch.int32, device=dev)

    def run():
        return pl.encode_probe(pc, None, ln, 32, 32, False, arr, False)

    hit, valid, cidx, oidx = run()
    torch.cuda.synchronize()
    sub = rng.choice(Q, 1 << 20, replace=False)
    want_v, want_f = probe_np(q[sub], slots, uvals, inline, arr.lgnb, arr.vbits)
    got_f = hit[:, 0].cpu().numpy()[sub]
    got_v = (oidx[:, 0].cpu().numpy().view(np.uint32)[sub].astype(np.uint64)
             << np.uint64(32)) | cidx[:, 0].cpu().numpy().view(np.uint32)[sub]
    require(bool(valid.all()), "scale probe: a query window is not valid")
    require(np.array_equal(got_f, want_f), "scale probe: found differs")
    require(np.array_equal(np.where(got_f, got_v, 0), np.where(want_f, want_v, 0)),
            "scale probe: values differ")
    require(bool(hit[: Q // 2].all()), "scale probe: a stored key was missed")
    ms = time_ms(run, iters=10)
    say(f"# scale: {n} keys, {slots.nbytes / 2**30:.2f} GiB of slots, host "
        f"placement {t_place:.1f}s; {Q} queries in {ms:.3f} ms = "
        f"{Q / ms * 1e3:.4g} queries/s; found/value exact on 1M queries; "
        f"{int(hit.sum())} found")
    return Q / ms * 1e3


def time_ms(fn, iters=20, warm=3):
    """Mean device milliseconds of fn() by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def phase_numbers(dev, clf, hiseq_path, deep):
    """Kernel vs plain times at the main path's shapes, stream reads/s.

    A K1-K3 call takes tens of microseconds on the card, about what the
    host takes to enqueue it, so each kernel and its plain version are
    timed by CUDA-graph replay (``graph_ms``); the event timing of
    back-to-back wrapper calls stands beside it as ``event_ms``."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.classify import resolve as rs
    from bonsai_tpu_torch.core.alphabet import DNA4
    from functools import partial

    from bonsai_tpu_torch.tools.bounds import (bound, bound_encode_probe,
                                               bound_resolve, bound_text,
                                               k1_rows, nbytes)
    from bonsai_tpu_torch.tools.gather_bench import graph_ms
    from bonsai_tpu_torch.tools.synthetic import deep_rows

    b = _batch(hiseq_path, 8192, DNA4.lut)
    # the batch in the mask channel (K1's mask instantiation, the
    # encode_probe row) and in its own, the sparse one
    mprep = _mask_only(clf)._prepare_batch(b)
    sprep = clf._prepare_batch(b)
    require((mprep.channel, sprep.channel) == ("mask", "sparse"),
            f"HiSeq 8192 channels {mprep.channel}, {sprep.channel}")
    n_reads = len(b.names)
    up = {ch: nbytes(p.pcodes, p.naux, p.lengths) / n_reads
          for ch, p in (("mask", mprep), ("sparse", sprep))}
    up["none"] = nbytes(sprep.pcodes, sprep.lengths) / n_reads
    say(f"# upload: HiSeq 8192 reads (lproc {sprep.lproc}), bytes a read by "
        f"channel: {up}; the sparse list holds "
        f"{int((sprep.nidx.numpy().view(np.uint32) != pl.N_SENTINEL).sum())}"
        f" of its {sprep.nidx.numel()} entries")
    (pc, nm, ln), _ = _k1_prep(mprep, dev)
    lproc = mprep.lproc
    ds = len(clf._uniq_host)
    a1 = (pc, nm, ln, lproc, clf.k, clf.canon, clf.arr, True)
    (spc, _, sln), nidx = _k1_prep(sprep, dev)
    a1s = (spc, None, sln, sprep.lproc, clf.k, clf.canon, clf.arr, True)
    hit, valid, cidx, oidx = pl.encode_probe(*a1)
    valid1 = valid.sum(-1, dtype=torch.int32)
    taxon = rs.resolve(cidx, hit, clf.tax, clf._n_distinct)
    a2 = (cidx, hit, clf.tax, clf._n_distinct)
    a3 = (taxon, oidx, hit, valid, valid1, clf.max_runs, ds)
    sparse_out = pl.encode_probe(*a1s, nidx=nidx)
    require(all(torch.equal(x, y) for x, y in zip(
        sparse_out, (hit, valid, cidx, oidx))), "K1 sparse differs from K1 "
        "mask on the HiSeq batch")
    bounds = {
        "encode_probe": bound_encode_probe((pc, nm, ln), clf.arr.vals,
                                           (hit, valid, cidx, oidx)),
        "encode_probe_sparse": bound_encode_probe(
            (spc, nidx, sln), clf.arr.vals, sparse_out),
        "resolve": bound_resolve(cidx, hit, clf.tax),
        "step_outputs": bound(nbytes(*a3[:5], *pl.step_outputs(*a3))),
    }
    # K2 again on the deep tree (2^21 nodes, every read ties two deep taxa)
    dc, dh = (torch.from_numpy(a).to(dev) for a in deep_rows(
        np.random.default_rng(SEED + 5), deep))
    dtax = deep.device_arrays(dev)
    a2d = (dc, dh, dtax, None)
    bounds["resolve deep"] = bound_resolve(dc, dh, dtax)
    times = {}
    for name, kern, plain, args in (
        ("encode_probe", pl.encode_probe, pl.encode_probe_plain, a1),
        ("encode_probe_sparse", partial(pl.encode_probe, nidx=nidx),
         partial(pl.encode_probe_plain, nidx=nidx), a1s),
        ("resolve", rs.resolve, rs.resolve_plain, a2),
        ("resolve deep", rs.resolve, rs.resolve_plain, a2d),
        ("step_outputs", pl.step_outputs, pl.build_step_outputs, a3),
    ):
        # plain, kernel, kernel, plain: the mean of each pair
        p1 = graph_ms(lambda: plain(*args), calls=20)
        k1 = graph_ms(lambda: kern(*args))
        k2 = graph_ms(lambda: kern(*args))
        p2 = graph_ms(lambda: plain(*args), calls=20)
        ev = time_ms(lambda: kern(*args), iters=100)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, ev)
        where = ("the deep tree's rows" if name == "resolve deep" else
                 f"B=8192 reads, P={hit.shape[1]}")
        say(f"# time {name} at {where}, CUDA-graph "
            f"replay: kernel {k1:.4f}, {k2:.4f} ms, plain torch on the card "
            f"{p1:.4f}, {p2:.4f} ms; events around back-to-back wrapper calls "
            f"{ev:.4f} ms; {bound_text(bounds[name])}")
    # K1 mask against K1 sparse on the same batch, in turns
    ab = [graph_ms(lambda: pl.encode_probe(*a1)),
          graph_ms(lambda: pl.encode_probe(*a1s, nidx=nidx)),
          graph_ms(lambda: pl.encode_probe(*a1s, nidx=nidx)),
          graph_ms(lambda: pl.encode_probe(*a1))]
    say(f"# time K1 on the HiSeq batch, CUDA-graph replay in turns: mask "
        f"{ab[0]:.4f}, sparse {ab[1]:.4f}, sparse {ab[2]:.4f}, mask "
        f"{ab[3]:.4f} ms: sparse / mask {(ab[1] + ab[2]) / (ab[0] + ab[3]):.4f}")
    # device busy share over one HiSeq pass, from a profiler trace
    from torch.profiler import ProfilerActivity, profile

    sink = open(os.devnull, "w")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clf.process_dataset(hiseq_path, sink, batch_size=8192)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    dev_ev = [(e.key, getattr(e, "self_device_time_total", 0))
              for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    dev_ev = sorted((e for e in dev_ev if e[1] > 0), key=lambda e: -e[1])
    busy = sum(us for _, us in dev_ev)
    say(f"# trace: one HiSeq pass (10000 reads): wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms "
        f"({'not measured' if not busy else f'{100 * busy / wall_us:.2f}%'}); "
        "top: " + "; ".join(f"{k[:40]} {us / 1e3:.3f} ms" for k, us in dev_ev[:6]))
    # steady-state stream: 20 passes of HiSeq in one process_dataset
    path = os.path.join(ROOT, "build", "hiseq_x20.fa")
    with open(hiseq_path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        for _ in range(20):
            fh.write(data)
    # the stream through the classifier (its batches sparse) and through
    # the same arrays with _sparse_n_ok False (the N mask), in turns
    mclf = _mask_only(clf)
    for c in (clf, mclf):
        c.process_dataset(hiseq_path, sink, batch_size=8192)  # warm pass
    torch.cuda.synchronize()
    wrappers = (pl.encode_probe, rs.resolve, pl.step_outputs)
    rates = {"sparse": [], "mask": []}
    for ch, c in (("sparse", clf), ("mask", mclf), ("mask", mclf),
                  ("sparse", clf)):
        before = [w.launches for w in wrappers]
        variants = dict(pl.encode_probe.variants)
        t0 = time.perf_counter()
        c.process_dataset(path, sink, batch_size=8192, profile=True)
        secs = time.perf_counter() - t0
        per_stream = {w.__name__: w.launches - n
                      for w, n in zip(wrappers, before)}
        k1v = {v: n - variants.get(v, 0)
               for v, n in pl.encode_probe.variants.items()
               if n > variants.get(v, 0)}
        rates[ch].append(200000 / secs)
        say(f"# stream ({ch} channel): 200000 HiSeq reads (batch 8192, "
            f"emit-all text to /dev/null) in {secs:.3f}s = "
            f"{200000 / secs:.6g} reads/s; stages "
            f"{ {k: round(v, 3) for k, v in c.stage_seconds.items()} }; "
            f"kernel launches {per_stream}, K1 {k1v}")
        # a batch without an in-read N takes K1's contiguous "none"
        want = "sparse" if ch == "sparse" else "contiguous"
        require(want in k1v and set(k1v) <= {want, "contiguous"},
                f"the {ch} stream ran K1 {k1v}")
    sink.close()
    os.unlink(path)
    rps = sum(rates["sparse"]) / 2
    say(f"# stream: sparse channel {rates['sparse']}, mask channel "
        f"{rates['mask']} reads/s (in turns sparse, mask, mask, sparse): "
        f"sparse / mask {rps / (sum(rates['mask']) / 2):.4f}")
    return times, bounds, rps, k1_rows((hit, valid))


def _ec_chunk(w):
    """The first block + w - 1 bases of GCF_000005845.2 as (1, L) codes."""
    import numpy as np

    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.io import fastx

    path = os.path.join(DATA, "ec", "GCF_000005845.2_ASM584v2_genomic.fna.gz")
    seq = next(iter(fastx.read_fastx(path)))[1][: (1 << 22) + w - 1]
    codes = fastx.encode_contig(seq, DNA4.lut)[None, :]
    return codes, np.array([codes.shape[1]], dtype=np.int32)


def _key_pool(rng, n):
    """n distinct random u64 keys, sorted (bit 63 set in half of them)."""
    import numpy as np

    from bonsai_tpu_torch.db.table import unique_u64

    return unique_u64(rng.integers(0, 2**64, n + n // 16, dtype=np.uint64))[:n]


def _random_state(rng, pool, n, cap, taxa_pool, tree):
    """Host arrays of a sorted-unique state: n keys of ``pool`` (two
    states from one pool share about n^2 / len(pool) keys) with taxa from
    ``taxa_pool``, padded to cap."""
    import numpy as np

    keys = np.sort(rng.choice(pool, n, replace=False))
    taxa = rng.choice(taxa_pool, n).astype(np.uint32)
    st = [np.full(cap, 2**64 - 1, np.uint64), np.ones(cap, np.uint8),
          np.zeros(cap, np.int32), np.zeros(cap, np.uint32),
          np.zeros(cap, np.uint32)]
    for a, v in zip(st, (keys, 0, tree.compact(taxa, missing_ok=True), taxa,
                         1)):
        a[:n] = v
    return st


def _kb2_case(rng, E, kind):
    """(keys, emitted) CPU tensors of one KB2 case: duplicates, keys below
    2^50 (the top digit's pass is skipped), every key equal, keys that
    differ in one middle digit only, one emitted key."""
    import numpy as np
    import torch

    keys = rng.integers(0, 2**64, E, dtype=np.uint64)
    keys[rng.integers(0, E, E // 3)] = keys[rng.integers(0, E, E // 3)]
    if kind == "below2^50":
        keys >>= np.uint64(14)
    elif kind == "allequal":
        keys[:] = keys[0]
    elif kind == "middledigit":
        digit = np.uint64(0xFF << 24)
        keys = (keys[0] & ~digit) | ((keys & np.uint64(0xFF)) << np.uint64(24))
    emitted = rng.random(E) < 0.8
    if kind == "oneemitted":
        emitted[:] = False
        emitted[E // 2] = True
    return (torch.from_numpy(keys.view(np.int64)), torch.from_numpy(emitted))


KB1_RUN, KB1_TILE = 16, 4096  # csrc/minimizers.cu: slots a thread, a block
KB3_TILE = 2048  # csrc/merge_fold.cu: output slots a tile
# (taxid in a, taxid in b) of the eight lca() corners of the small tree
KB3_CORNERS = [(11, 12), (11, 13), (11, 0), (999, 999), (999, 11), (11, 51),
               (0, 0), (12, 12)]


def _kb1_edge_rows(rng, k, W):
    """Rows with Ns at the first and last slot of a thread's run and at
    tile edges, an N run longer than k across a tile edge, a row of T and
    one of G/T bases (U64_MAX and bit 63 at k = 32), a row shorter than k;
    L is not a multiple of the run and E is odd."""
    import numpy as np

    L = 2 * KB1_TILE + 37 + k + W
    codes = rng.integers(0, 4, (5, L)).astype(np.int8)
    for p in (0, KB1_RUN - 1, KB1_RUN, 2 * KB1_RUN - 1, KB1_TILE - 1, KB1_TILE,
              KB1_TILE + KB1_RUN - 1, 2 * KB1_TILE + 5):
        codes[0, p] = -1
    codes[1, KB1_TILE - 20 : KB1_TILE + k + 20] = -1
    codes[2] = 3
    codes[2, 1000:1003] = 0
    codes[3] = rng.integers(2, 4, L)
    lengths = np.array([L, L - 3, L, L - KB1_TILE, k - 1], dtype=np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def _placed_states(rng, tree, pairs_at, n_after, corners=(), u64max=False):
    """Host arrays of two states whose merged order holds a pair (a's entry
    at slot p - 1, b's at p) for each p of ``pairs_at``, the pairs taking
    the taxa of ``corners`` in turn; singles elsewhere, ``n_after`` after
    the last pair; a real U64_MAX key in both last where ``u64max``.
    Returns (a, na, b, nb)."""
    import numpy as np

    where, pos = [], 0  # per distinct key: "a", "b" or "ab"
    for p in sorted(pairs_at):
        while pos < p - 1:
            where.append("ab"[rng.integers(0, 2)])
            pos += 1
        where.append("ab")
        pos += 2
    where += ["ab"[rng.integers(0, 2)] for _ in range(n_after)]
    if u64max:
        where.append("ab")
    distinct = np.unique(rng.integers(0, 2**64 - 1, 2 * len(where) + 8,
                                      dtype=np.uint64))
    keys = np.sort(rng.choice(distinct, len(where), replace=False))
    if u64max:
        keys[-1] = np.uint64(2**64 - 1)
    pool = np.array([0, 999, *tree.tax_ids], dtype=np.uint64)
    cs = iter(corners)
    kk = {"a": [], "b": []}
    taxa = {"a": [], "b": []}
    for key, w in zip(keys, where):
        tx = next(cs, None) if w == "ab" else None
        for s, t in zip("ab", tx or rng.choice(pool, 2)):
            if s in w:
                kk[s].append(key)
                taxa[s].append(t)
    out = []
    for s in "ab":
        n = len(kk[s])
        cap = 1 << max(int(n - 1).bit_length(), 3)
        t = np.array(taxa[s], dtype=np.uint32)
        st = [np.full(cap, 2**64 - 1, np.uint64), np.ones(cap, np.uint8),
              np.zeros(cap, np.int32), np.zeros(cap, np.uint32),
              np.zeros(cap, np.uint32)]
        for a, v in zip(st, (np.array(kk[s], dtype=np.uint64), 0,
                             tree.compact(t, missing_ok=True), t,
                             rng.integers(1, 4, n))):
            a[:n] = v
        out += [st, n]
    return out


def phase_build_kernels(dev, chk, kk):
    """KB1-KB3, G1, G2 on the card vs their plain versions on CPU copies."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.db import build_device as bd
    from bonsai_tpu_torch.taxonomy.tree import TaxTree
    from bonsai_tpu_torch.tools import gather_bench as gb

    rng = np.random.default_rng(SEED + 2)

    def kb1(codes, lengths, k, W, canon, tag):
        c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
        got = enc.minimizers(c.to(dev), ln.to(dev), k, W, canon)
        chk.same("minimizers", got, enc.minimizers_plain(c, ln, k, W, canon),
                 tag)
        return got

    def kb2(keys, emitted, tag):
        got = bd.sort_unique(keys.to(dev), emitted.to(dev))
        chk.same("sort_unique", got, bd.sort_unique_plain(
            keys.cpu(), emitted.cpu(), got[0].shape[0]), tag)
        return got

    # KB1 and KB2 on one 4M-base ec chunk, as the k = 31 builds see it
    for w, canon in ((31, True), (40, True), (31, False)):
        codes, lengths = _ec_chunk(w)
        em = kb1(codes, lengths, 31, w - 30, canon,
                 f"ec chunk k=31 w={w} canon={canon}")
        out = kb2(em.values[0], em.mask[0],
                  f"ec chunk k=31 w={w} canon={canon}: {em.mask.sum()} keys")
    say(f"# build kernels: ec chunk: {int(out[2])} distinct of "
        f"{em.values.shape[1]} k-mers (k=31, uncanonical)")
    # synthetic rows: in-read Ns, rows shorter than k, T runs (k = 32
    # uncanonical k-mer U64_MAX), every base (bit 63 set)
    codes = rng.integers(0, 4, (256, 1000)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = -1
    codes[:8, 100:200] = 3
    lengths = rng.integers(900, 1001, 256).astype(np.int32)
    lengths[8:40] = rng.integers(0, 32, 32)
    codes[np.arange(1000)[None, :] >= lengths[:, None]] = -1
    for k, W, canon in ((32, 1, False), (32, 1, True), (21, 1, True),
                        (32, 10, True), (25, 13, True), (31, 32, True)):
        em = kb1(codes, lengths, k, W, canon, f"rows k={k} W={W}")
        out = kb2(em.values.reshape(-1), em.mask.reshape(-1),
                  f"rows k={k} W={W}")
        if (k, canon) == (32, False):
            n = int(out[2])
            require(int(out[0][n - 1]) == -1 and int(out[1][n - 1]) == 0,
                    "KB2: a real U64_MAX key is missing or padded")
    kb1(codes[:, :40].copy(), lengths, 31, 11, True, "P < W")
    kb1(codes[:, :20].copy(), lengths, 21, 1, True, "L < k")
    # Ns at the ends of a thread's run and at tile edges, N runs longer than
    # k, k = 32 with bit 63 and U64_MAX, rows shorter than k, ragged L
    for k, W, canon in ((32, 1, False), (32, 1, True), (31, 1, True),
                        (31, 2, True), (31, 10, True), (21, 17, True),
                        (32, 17, True)):
        kb1(*_kb1_edge_rows(rng, k, W), k, W, canon,
            f"run and tile edges k={k} W={W} canon={canon}")
    kb2(torch.zeros(5000, dtype=torch.int64), torch.zeros(5000, dtype=torch.bool),
        "all pads")
    # the radix passes' edge cases: skipped passes, one run, one key, a
    # ragged last tile, ~1000 tiles of look-back; then two calls queued
    # back to back, which must clear the counters and status words again
    for E, kind in ((3 * 4096 + 1, "below2^50"), (3 * 4096 + 1, "dups"),
                    (5000, "allequal"), (70_000, "middledigit"),
                    (5000, "oneemitted"), (1 << 22, "dups")):
        kb2(*_kb2_case(rng, E, kind), f"{E} keys, {kind}")
    cases = [_kb2_case(rng, 1 << 18, kind) for kind in ("dups", "below2^50")]
    got = [bd.sort_unique(k.to(dev), e.to(dev)) for k, e in cases]
    for g, (k, e), kind in zip(got, cases, ("dups", "below2^50")):
        chk.same("sort_unique", g, bd.sort_unique_plain(k, e, 1 << 18),
                 f"two calls in a row: {kind}")

    # KB3: the eight lca() corners, then 2^22 + 2^22 random states
    small = TaxTree({1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3, 5: 0, 51: 5})
    ta = {10: 11, 20: 11, 30: 11, 40: 999, 50: 999, 60: 11, 70: 0, 80: 12}
    tb = {10: 12, 20: 13, 30: 0, 40: 999, 50: 11, 60: 51, 70: 0}

    def corner_state(d):
        n = len(d)
        st = [np.full(8, 2**64 - 1, np.uint64), np.ones(8, np.uint8),
              np.zeros(8, np.int32), np.zeros(8, np.uint32),
              np.zeros(8, np.uint32)]
        taxa = np.array([d[x] for x in sorted(d)], dtype=np.uint32)
        for a, v in zip(st, (sorted(d), 0, small.compact(taxa, missing_ok=True),
                             taxa, 1)):
            a[:n] = v
        return st, n

    def kb3(a, na, b, nb, tree, sum_counts, tag):
        root1 = int(tree.compact(np.array([1], dtype=np.uint32))[0])
        got = bd.merge_fold(bd.State.from_numpy(*a, na, dev),
                            bd.State.from_numpy(*b, nb, dev),
                            tree.device_arrays(dev), root1, sum_counts)
        want = bd.merge_fold_plain(bd.State.from_numpy(*a, na, "cpu"),
                                   bd.State.from_numpy(*b, nb, "cpu"),
                                   tree.device_arrays("cpu"), root1, sum_counts)
        f = ("keys", "pad", "node", "orig", "cnt", "n")
        chk.same("merge_fold", [getattr(got, x) for x in f],
                 [getattr(want, x) for x in f], tag)
        return got

    ec_tree = TaxTree.from_nodes_dmp(os.path.join(GOLD, kk["nodes"]))
    pool = np.concatenate([ec_tree.tax_ids, [0, 999]]).astype(np.uint32)
    for sc in (False, True):
        got = kb3(*corner_state(ta), *corner_state(tb), small, sc,
                  f"corners sum_counts={sc}")
        keys, _, _, orig, cnt, n = got.numpy()
        require(dict(zip(keys[:n].tolist(), orig[:n].tolist())) == {
            10: 2, 20: 1, 30: 11, 40: 999, 50: 0xFFFFFFFF, 60: 1, 70: 0,
            80: 12}, "KB3: an lca() corner case is wrong")
        require(int(cnt[0]) == (2 if sc else 1), "KB3: counts")
        n, keys = 3 << 20, _key_pool(rng, 5 << 20)
        kb3(_random_state(rng, keys, n, 1 << 22, pool, ec_tree), n,
            _random_state(rng, keys, n, 1 << 22, pool, ec_tree), n, ec_tree,
            sc, f"random 2^22 + 2^22 sum_counts={sc}")
        # pairs across tile edges with the lca() corners there, both state
        # orders, and a real U64_MAX pair next to the pads; whole tiles of
        # pairs from a tile edge and from one slot after it
        edges = [KB3_TILE * (t + 1) for t in range(len(KB3_CORNERS))]
        a, na, b, nb = _placed_states(rng, small, edges, 1000, KB3_CORNERS,
                                      u64max=True)
        kb3(a, na, b, nb, small, sc, f"pairs across tile edges sc={sc}")
        kb3(b, nb, a, na, small, sc, f"pairs across tile edges, b first sc={sc}")
        pairs = [KB3_TILE + 1 + 2 * i for i in range(KB3_TILE // 2)]
        pairs += [3 * KB3_TILE + 2 + 2 * i for i in range(KB3_TILE // 2)]
        kb3(*_placed_states(rng, small, pairs, 300), small, sc,
            f"whole tiles of pairs sc={sc}")
    # empty states and a state far smaller than a tile
    for na, ca, nb, cb in ((0, 0, 0, 0), (0, 0, 5, 8), (3000, 4096, 0, 0),
                           (3, 8, 50_000, 65536), (50_000, 65536, 1, 8)):
        kb3(_random_state(rng, keys, na, ca, pool, ec_tree), na,
            _random_state(rng, keys, nb, cb, pool, ec_tree), nb, ec_tree, True,
            f"capacities {ca} + {cb}")
    # two calls queued back to back: counters and status words cleared again
    root1 = int(ec_tree.compact(np.array([1], dtype=np.uint32))[0])
    cases = [[_random_state(rng, keys, n, cap, pool, ec_tree) for _ in "ab"]
             + [n] for n, cap in ((40_000, 65536), (70_000, 131072))]
    got = [bd.merge_fold(bd.State.from_numpy(*sa, n, dev),
                         bd.State.from_numpy(*sb, n, dev),
                         ec_tree.device_arrays(dev), root1, True)
           for sa, sb, n in cases]
    fields = ("keys", "pad", "node", "orig", "cnt", "n")
    for g, (sa, sb, n) in zip(got, cases):
        want = bd.merge_fold_plain(bd.State.from_numpy(*sa, n, "cpu"),
                                   bd.State.from_numpy(*sb, n, "cpu"),
                                   ec_tree.device_arrays("cpu"), root1, True)
        chk.same("merge_fold", [getattr(g, f) for f in fields],
                 [getattr(want, f) for f in fields], f"two calls in a row: {n}")

    # G1 at variant F's shape and 32-B rows; G2 at its four shapes
    tbl, idx = gb.f_case(dev, SEED)
    chk.same("row_gather", [gb.row_gather(tbl, idx)],
             [gb.row_gather_plain(tbl.cpu(), idx.cpu())], "variant F")
    del tbl
    tbl = torch.from_numpy(rng.integers(-2**31, 2**31, (1 << 20, 8)
                                        ).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 1 << 20, 1 << 20).astype(np.int32))
    chk.same("row_gather", [gb.row_gather(tbl.to(dev), idx.to(dev))],
             [gb.row_gather_plain(tbl, idx)], "32-B rows")
    for name, tab, ix, axis in gb.take_cases(dev):
        chk.same("take_along", [gb.take_along(tab, ix, axis)],
                 [gb.take_along_plain(tab.cpu(), ix.cpu(), axis)], name)
    # G2 at a ragged Q, at widths not a multiple of 4, at axis 1, Ci != Ct
    for axis, R, Ct, Q, Ci in ((0, 1000, 128, 1001, 128), (0, 37, 6, 5, 6),
                               (1, 77, 48, 77, 70), (1, 1024, 128, 1024, 64)):
        tab = torch.from_numpy(rng.integers(-2**31, 2**31, (R, Ct)
                                            ).astype(np.int32))
        ix = torch.from_numpy(rng.integers(0, R if axis == 0 else Ct, (Q, Ci)
                                           ).astype(np.int32))
        chk.same("take_along", [gb.take_along(tab.to(dev), ix.to(dev), axis)],
                 [gb.take_along_plain(tab, ix, axis)],
                 f"axis {axis} ({R}, {Ct}) table, ({Q}, {Ci}) indices")
    discipline_kernels(dev, chk)
    torch.cuda.synchronize()
    say(f"# build kernels: all equal to their plain versions: "
        f"{ {k: chk.cases[k] for k in list(KERNELS)[3:]} } cases")


def _positions(k, spacing):
    from bonsai_tpu_torch.core.spacer import Spacer

    return tuple(int(p) for p in Spacer(k, k, spacing).positions)


def _discipline_rows(rng, c, W, L=300, B=48):
    """Rows with 2% Ns, an N run longer than the span, a row of T (k = 32:
    U64_MAX), a row of G/T (bit 63 set), an all-N row, rows shorter than
    the span, rows with 0 < n_valid < W, padded with -1."""
    import numpy as np

    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = -1
    lengths = rng.integers(c, L + 1, B).astype(np.int32)
    codes[0, 40 : 40 + c + 20] = -1
    codes[1] = 3
    lengths[1] = L
    codes[2] = rng.integers(2, 4, L)
    codes[3] = -1
    lengths[4:8] = rng.integers(0, c, 4)
    lengths[8:12] = c - 1 + rng.integers(1, W + 1, 4)
    codes[8] = rng.integers(0, 4, L)  # one clean seed: n_valid = 1
    lengths[8] = c
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def _short_rows(rng, B, L):
    """B rows of at most L bases, 5% Ns: rows shorter than k and P < W."""
    import numpy as np

    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.05] = -1
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def discipline_kernels(dev, chk):
    """KB1's spaced and entropy-file instantiations and KB4 on the card
    against their plain versions on CPU copies: 4M-base ec chunks at the
    builds' shapes, then rows of every kind at W = 1, 2, 13, 16."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.core import encoder as enc

    rng = np.random.default_rng(SEED + 7)
    pos21 = _positions(21, SPACING21)
    pos32 = _positions(32, "1x31")  # every other base: span 63

    def kb1(codes, lengths, k, W, canon, scheme, pos, tag):
        name = ("minimizers_spaced" if pos is not None else
                "minimizers_entropy" if scheme != "lex" else "minimizers")
        c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
        got = enc.minimizers(c.to(dev), ln.to(dev), k, W, canon, scheme, pos)
        chk.same(name, got, enc.minimizers_plain(c, ln, k, W, canon, scheme,
                                                 pos), tag)
        return got

    def kb4(codes, lengths, k, W, scheme, tag):
        c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
        got = enc.compacted_minimizers(c.to(dev), ln.to(dev), k, W, scheme)
        chk.same("compacted_minimizers", got,
                 enc.compacted_minimizers_plain(c, ln, k, W, scheme), tag)
        return got

    # 4M-base ec chunks, as the -S, -S -e -w 40, -e, -C and -C -e builds
    # see them
    for w, run in ((25, lambda c, n: kb1(c, n, 21, 1, False, "lex", pos21,
                                         "ec chunk -S")),
                   (40, lambda c, n: kb1(c, n, 21, 16, False, "entropy-file",
                                         pos21, "ec chunk -S -e -w 40")),
                   (37, lambda c, n: kb1(c, n, 25, 13, True, "entropy-file",
                                         None, "ec chunk -k 25 -w 37 -e")),
                   (40, lambda c, n: kb4(c, n, 31, 10, "lex",
                                         "ec chunk -C -k 31 -w 40")),
                   (37, lambda c, n: kb4(c, n, 25, 13, "entropy-file",
                                         "ec chunk -C -k 25 -w 37 -e"))):
        em = run(*_ec_chunk(w))
    say(f"# build kernels: ec chunk -C -e: {int(em.mask.sum())} minimizers "
        f"of {em.values.shape[1]} slots")
    # rows: Ns, N runs longer than the span, all-N rows, short rows,
    # n_valid < W tails, k = 32 bit 63 and U64_MAX; then Ns at KB1's
    # thread-run and tile edges
    for W in (1, 2, 13, 16):
        for scheme in ("lex", "entropy-file"):
            for k, pos in ((21, pos21), (32, pos32)):
                kb1(*_discipline_rows(rng, pos[-1] + 1, W), k, W, False,
                    scheme, pos, f"rows -S k={k} W={W} {scheme}")
            for k in (21, 31, 32):
                kb4(*_discipline_rows(rng, k, W), k, W, scheme,
                    f"rows -C k={k} W={W} {scheme}")
            codes, lengths = _kb1_edge_rows(rng, 25, W)
            kb1(codes, lengths, 21, W, False, scheme, pos21,
                f"run and tile edges -S W={W} {scheme}")
            codes[4, : 2 * KB1_TILE] = -1  # a tile with no valid seed
            lengths[4] = codes.shape[1]
            kb4(codes, lengths, 31, W, scheme,
                f"run and tile edges -C W={W} {scheme}")
        if W > 1:
            for k in (25, 32):
                kb1(*_discipline_rows(rng, k, W), k, W, True, "entropy-file",
                    None, f"rows -e k={k} W={W}")
                kb1(*_kb1_edge_rows(rng, k, W), k, W, True, "entropy-file",
                    None, f"run and tile edges -e k={k} W={W}")
    # KB4 on 3000 short rows (P < W: the tail column alone), then twice
    # in a row on one stream
    codes, lengths = _short_rows(rng, 3000, 40)
    kb4(codes, lengths, 21, 13, "lex", "3000 rows of 40")
    kb4(codes, lengths, 31, 16, "entropy-file", "3000 rows of 40, P < W")
    cases = [_discipline_rows(rng, 31, 10, L=9000, B=16) for _ in range(2)]
    got = [enc.compacted_minimizers(torch.from_numpy(c).to(dev),
                                    torch.from_numpy(n).to(dev), 31, 10)
           for c, n in cases]
    for g, (c, n) in zip(got, cases):
        chk.same("compacted_minimizers", g, enc.compacted_minimizers_plain(
            torch.from_numpy(c), torch.from_numpy(n), 31, 10),
            "two calls in a row")


def _device_busy(prof):
    """(device-busy microseconds, top kernels) of a profiler trace."""
    from torch.autograd import DeviceType

    ev = [(e.key, getattr(e, "self_device_time_total", 0))
          for e in prof.key_averages()
          if getattr(e, "device_type", None) == DeviceType.CUDA]
    ev = sorted((e for e in ev if e[1] > 0), key=lambda e: -e[1])
    return sum(us for _, us in ev), ev


def phase_device_build(dev, kk, host_secs):
    """The slice's main path: build --device-build on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bonsai_tpu_torch import cli
    from bonsai_tpu_torch.core.encoder import compacted_minimizers, minimizers
    from bonsai_tpu_torch.core.spacer import Spacer, parse_spacing
    from bonsai_tpu_torch.db import build_device as bd
    from bonsai_tpu_torch.db.build import content_digest
    from bonsai_tpu_torch.db.formats import load_database
    from bonsai_tpu_torch.db.table import KmerTable
    from bonsai_tpu_torch.taxonomy.tree import TaxTree

    wrappers = [minimizers, compacted_minimizers, bd.sort_unique,
                bd.merge_fold]
    reset_counts(wrappers)
    tree = TaxTree.from_nodes_dmp(os.path.join(GOLD, kk["nodes"]))
    genomes = [os.path.join(DATA, "ec", g) for g in kk["genomes"]]
    nameid = os.path.join(GOLD, kk["nameid"])
    nums = {}
    for w, want in ((31, kk["db_digest"]), (40, EC_W40_DIGEST)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        table = bd.device_lca_map(genomes, tree, nameid, Spacer(31, w),
                                  device=dev)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = content_digest(table)
        say(f"# device build: ec k=31 w={w}: {table.n} k-mers in {secs:.3f}s "
            f"= {table.n / secs:.6g} k-mers/s (first run); peak device memory "
            f"{peak / 2**20:.1f} MiB; digest "
            f"{'matches' if got == want else 'DIFFERS'}")
        require(got == want, f"ec k=31 w={w} device build differs")
        nums[w] = {"secs": secs, "n": table.n, "peak": peak}
        if w == 31:
            say(f"# device build: ec k=31: kernel launches "
                f"{read_counts(wrappers)}")
    # the seed disciplines of -S, -e and -C -w on the ec corpus, by stage
    # (device_lca_map's own three steps)
    spaced_table = None
    for flags, k, w, spacing, canon, scheme, want in EC_DISCIPLINES:
        sp = Spacer(k, w, parse_spacing(spacing, k))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        states, tax, root1 = bd._device_gather(genomes, tree, nameid, sp,
                                               canon, 1 << 22, dev, scheme)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        keys, taxa = bd._finish_fold(states, tax, root1, False)
        t2 = time.perf_counter()
        del states
        table = KmerTable(keys, taxa)
        t3 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        got = content_digest(table)
        say(f"# device build: ec {flags}: {table.n} k-mers in {t3 - t0:.3f}s "
            f"= {table.n / (t3 - t0):.6g} k-mers/s (first run): genomes -> "
            f"states {t1 - t0:.3f}s, tree fold + fetch {t2 - t1:.3f}s, table "
            f"placement (host) {t3 - t2:.3f}s; peak device memory "
            f"{peak / 2**20:.1f} MiB; digest "
            f"{'matches' if got == want else 'DIFFERS'} the JAX package's")
        require(got == want, f"ec {flags} device build differs")
        nums[flags] = {"secs": t3 - t0, "n": table.n, "peak": peak}
        if spacing:
            spaced_table = table
    # a second k = 31 build, by stage, with a profiler trace of the fold
    sp = Spacer(31, 31)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        states, tax, root1 = bd._device_gather(genomes, tree, nameid, sp,
                                               True, 1 << 22, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        keys, taxa = bd._finish_fold(states, tax, root1, False)
        t2 = time.perf_counter()
    del states
    table = KmerTable(keys, taxa)
    t3 = time.perf_counter()
    busy, top = _device_busy(prof)
    wall = (t2 - t0) * 1e6
    require(content_digest(table) == kk["db_digest"], "second ec build differs")
    say(f"# device build: ec k=31 again: genomes -> states {t1 - t0:.3f}s, "
        f"tree fold + fetch {t2 - t1:.3f}s, table placement (host) "
        f"{t3 - t2:.3f}s; total {t3 - t0:.3f}s = {table.n / (t3 - t0):.6g} "
        f"k-mers/s; host build of the same corpus {host_secs:.3f}s = "
        f"{table.n / host_secs:.6g} k-mers/s")
    say(f"# trace: device busy {busy / 1e3:.3f} ms of {wall / 1e3:.3f} ms "
        f"({100 * busy / wall:.2f}%) in genomes -> states + fold; top: "
        + "; ".join(f"{k[:40]} {us / 1e3:.3f} ms" for k, us in top[:8]))
    nums["again"] = {"secs": t3 - t0, "gather": t1 - t0, "fold": t2 - t1,
                     "place": t3 - t2, "busy_ms": busy / 1e3,
                     "wall_ms": wall / 1e3}
    # the goldens through the CLI, on the card
    m = json.load(open(os.path.join(GOLD, "manifest.json")))
    gold = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                             "g_rand.fa")]
    nodes, nmap = os.path.join(GOLD, "nodes.dmp"), os.path.join(GOLD,
                                                                "nameidmap.txt")
    dflags = ["--device-build", "--device", str(dev)]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        runs = []  # (what, argv, digest)
        for c in m["configs"]:
            out = os.path.join(tmp, f"{c['name']}.btpu")
            if c["phase1"] is None:
                argv = ["build", out, *gold, *c["flags"], "-T", nodes, "-M",
                        nmap, *dflags]
                runs.append((f"golden {c['name']}", argv, c["db_digest"]))
            elif c["phase1"] in ("t", "f"):
                argv = ["prebuild", nmap, nodes, out, *gold, "-k", "25",
                        f"-{c['phase1']}", *dflags]
                runs.append((f"golden prebuild {c['name']}", argv,
                             c["phase1_digest"]))
        for (cmd, flags), want in GOLDEN_JAX_DIGESTS.items():
            out = os.path.join(tmp, f"{len(runs)}.btpu")
            argv = (["build", out, *gold, *flags.split(), "-T", nodes, "-M",
                     nmap] if cmd == "build" else
                    ["prebuild", nmap, nodes, out, *gold, *flags.split()])
            runs.append((f"{cmd} {flags} (the JAX CLI's digest)",
                         argv + dflags, want))
        for what, argv, want in runs:
            t0 = time.perf_counter()
            require(cli.main(argv) == 0, f"port CLI {what} failed")
            secs = time.perf_counter() - t0
            got = content_digest(load_database(argv[1 if argv[0] == "build"
                                                    else 3]).table)
            say(f"# device build: {what}: {secs:.3f}s; digest "
                f"{'matches' if got == want else 'DIFFERS'}")
            require(got == want, f"{what}: device build differs")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    for r in HASH_ROWS + API_ROWS:  # phase 9c's and 9d's
        launches.pop(r, None)
    say(f"# device build: kernel launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the device build")
    return launches, nums, spaced_table


def phase_spaced_classify(dev, chk, kk, table, hiseq):
    """K1's spaced instantiation, then the HiSeq set against the spaced ec
    database of phase 9 (-k 21 -S 0x16,1x4): Kraken text = the JAX
    Classifier's."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.classify import resolve as rs
    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.core.spacer import parse_spacing
    from bonsai_tpu_torch.db.formats import Database
    from bonsai_tpu_torch.db.table import ProbeArrays
    from bonsai_tpu_torch.taxonomy.tree import TaxTree
    from bonsai_tpu_torch.tools.bounds import (bound_encode_probe, bound_text,
                                               spaced_runs)
    from bonsai_tpu_torch.tools.gather_bench import graph_ms

    tree = TaxTree.from_nodes_dmp(os.path.join(GOLD, kk["nodes"]))
    db = Database(table=table, k=21, w=21, gaps=parse_spacing(SPACING21, 21))
    clf = pl.Classifier(db, tree, emit_all=True, device=dev)
    require(clf.positions is not None and clf.sp.c == 25 and not clf.canon,
            "the spaced classifier's seed")
    arr_cpu = ProbeArrays(clf.arr.slots.cpu(), clf.arr.vals.cpu(),
                          clf.arr.inline, clf.arr.lgnb, clf.arr.vbits)
    rng = np.random.default_rng(SEED + 8)

    def k1(batch, tag, paired=False):
        """K1 spaced in the batch's channel against its plain version; a
        sparse batch also against the mask instantiation on the same
        reads."""
        prep = clf._prepare_batch(batch, paired)
        args = (prep.lproc, clf.k, clf.canon)
        (pc, nm, ln), nidx = _k1_prep(prep, dev)
        got = pl.encode_probe(pc, nm, ln, *args, clf.arr, True,
                              clf.positions, nidx=nidx)
        (pc, nm, ln), nidx = _k1_prep(prep, None)
        chk.same("encode_probe_spaced", got, pl.encode_probe_plain(
            pc, nm, ln, *args, arr_cpu, True, clf.positions, nidx=nidx),
            f"{tag} ({prep.channel})")
        if prep.channel == "sparse":
            (pc, nm, ln), _ = _k1_prep(
                _mask_only(clf)._prepare_batch(batch, paired), dev)
            chk.same("encode_probe_spaced", got, [m.cpu() for m in
                     pl.encode_probe(pc, nm, ln, *args, clf.arr, True,
                                     clf.positions)], f"{tag}: = K1 mask")
        return prep.channel

    b = _batch(hiseq, 8192, DNA4.lut)
    require(k1(b, "HiSeq 8192") == "sparse", "HiSeq 8192 is not sparse")
    k1(b, "HiSeq paired", paired=True)
    codes, lengths = b.codes.copy(), b.lengths.copy()
    short = rng.choice(len(lengths), 512, replace=False)
    lengths[short] = rng.integers(1, 25, size=short.size)
    codes[np.arange(codes.shape[1])[None, :] >= lengths[:, None]] = -1
    rows = rng.integers(0, len(lengths), 2000)
    codes[rows, rng.integers(0, 101, rows.size)] = -1
    k1(type(b)(names=b.names, seqs=b.seqs, codes=codes, lengths=lengths,
               quals=b.quals), "HiSeq short+N")
    # the path: HiSeq against the spaced database
    wrappers = [pl.encode_probe, rs.resolve, pl.step_outputs]
    reset_counts(wrappers)
    out = io.StringIO()
    t0 = time.perf_counter()
    _, channels = _channels(clf, lambda: clf.process_dataset(
        hiseq, out, batch_size=8192))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = hashlib.sha256(out.getvalue().encode()).hexdigest()
    launches = read_counts(wrappers)
    say(f"# spaced classify: HiSeq against the ec -k 21 -S {SPACING21} "
        f"database: {out.getvalue().count(chr(10))} lines in {secs:.3f}s, "
        f"sha256 {'matches' if got == HISEQ_SPACED_SHA256 else 'DIFFERS'} "
        f"the JAX Classifier's; N channels {channels} (the JAX package's "
        f"{SET_CHANNELS[8192]['HiSeq']}); kernel launches {launches}, K1 "
        f"{pl.encode_probe.variants}")
    require(got == HISEQ_SPACED_SHA256,
            "HiSeq against the spaced database differs from the JAX package")
    require(channels == SET_CHANNELS[8192]["HiSeq"],
            f"spaced classify took N channels {channels}")
    require(pl.encode_probe.variants.get("spaced sparse", 0) > 0 and
            launches["encode_probe"] == 0 and
            launches["encode_probe_sparse"] == 0, "K1's spaced sparse "
            "kernel was not the one launched on the spaced path")
    # K1 spaced and its plain version, CUDA-graph replay and events: the
    # batch in the mask channel, the encode_probe_spaced row
    mp = _mask_only(clf)._prepare_batch(b)
    (pc, nm, ln), _ = _k1_prep(mp, dev)
    a1 = (pc, nm, ln, mp.lproc, clf.k, clf.canon, clf.arr, True,
          clf.positions)
    res = pl.encode_probe(*a1)
    bnd = bound_encode_probe(a1[:3], clf.arr.vals, res,
                             runs=spaced_runs(clf.positions))
    p1 = graph_ms(lambda: pl.encode_probe_plain(*a1), calls=20)
    t1, t2 = graph_ms(lambda: pl.encode_probe(*a1)), graph_ms(
        lambda: pl.encode_probe(*a1))
    p2 = graph_ms(lambda: pl.encode_probe_plain(*a1), calls=20)
    ev = time_ms(lambda: pl.encode_probe(*a1), iters=100)
    say(f"# time encode_probe_spaced at B=8192 reads, P={res[0].shape[1]}, "
        f"CUDA-graph replay: kernel {t1:.4f}, {t2:.4f} ms, plain torch on the "
        f"card {p1:.4f}, {p2:.4f} ms; events around back-to-back wrapper "
        f"calls {ev:.4f} ms; {bound_text(bnd)}")
    return ({"encode_probe_spaced": launches["encode_probe_spaced"]},
            ((t1 + t2) / 2, (p1 + p2) / 2, ev), bnd)


def _rows_map(rng, codes, lengths, k, canon, pos, mode):
    """A phase-1 map of half the seeds of rows ``codes`` (the last two rows
    left out), 0 and U64_MAX: 6 packed values (inline) or one a key
    (flat)."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.db.table import KmerTable, ScoreMap

    em = enc.minimizers_plain(torch.from_numpy(codes[:-2]),
                              torch.from_numpy(lengths[:-2]), k, 1, canon,
                              positions=pos)
    seeds = np.unique(em.values[em.mask].numpy().view(np.uint64))
    keys = np.unique(np.concatenate([
        rng.choice(seeds, seeds.size // 2, replace=False),
        np.array([0, 2**64 - 1], np.uint64)]))
    v = (np.arange(keys.size, dtype=np.uint64) if mode == "flat" else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    table = KmerTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v,
                      min_nb=0 if mode == "flat" else 1 << 10)
    require(table.arrays_np()[2] == (mode == "inline"), f"{mode} image")
    return ScoreMap(table)


def _hash_rows(rng, c, W):
    """``_discipline_rows`` with a poly-A run (the k-mer 0)."""
    codes, lengths = _discipline_rows(rng, c, W)
    codes[12, : c + 3 * W] = 0
    lengths[12] = codes.shape[1]
    return codes, lengths


def hash_kernels(dev, chk, maps):
    """KB5 and KB1's and KB4's score::Hash instantiations on the card
    against their plain versions on CPU copies, exact."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.db.table import (KmerTable, ScoreMap, lookup_scores,
                                           lookup_scores_plain, unique_u64)

    rng = np.random.default_rng(SEED + 9)
    pos21 = _positions(21, SPACING21)
    pos32 = _positions(32, "1x31")

    def kb1(codes, lengths, k, W, canon, pos, smap, tag):
        name = "minimizers_spaced_hash" if pos else "minimizers_hash"
        c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
        got = enc.minimizers(c.to(dev), ln.to(dev), k, W, canon, "hash", pos,
                             smap)
        chk.same(name, got, enc.minimizers_plain(c, ln, k, W, canon, "hash",
                                                 pos, smap), tag)
        return got

    def kb4(codes, lengths, k, W, smap, tag):
        c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
        got = enc.compacted_minimizers(c.to(dev), ln.to(dev), k, W, "hash",
                                       smap)
        chk.same("compacted_minimizers_hash", got,
                 enc.compacted_minimizers_plain(c, ln, k, W, "hash", smap),
                 tag)
        return got

    # a flat image: the distinct canonical 25-mers of an ec chunk, one
    # value each (more than the slot's index field holds)
    codes37, len37 = _ec_chunk(37)
    em = enc.minimizers_plain(torch.from_numpy(codes37),
                              torch.from_numpy(len37), 25, 1, True)
    keys = unique_u64(em.values[em.mask].numpy().view(np.uint64))
    flat = ScoreMap(KmerTable(keys, (np.uint64(7) << np.uint64(32)) |
                              np.arange(keys.size, dtype=np.uint64)))
    require(not flat.arrays("cpu").inline, "the flat image is flat")
    td = maps["-k 25 -w 37 -t"]
    for smap, tag in ((td, "the ec -k 25 -t map (inline)"),
                      (flat, "a flat image of an ec chunk's 25-mers")):
        keys = smap.table.keys_sorted
        q = np.concatenate([rng.choice(keys, 1 << 21),
                            rng.integers(0, 2**64, (1 << 21) - 2,
                                         dtype=np.uint64),
                            np.array([0, 2**64 - 1], np.uint64)])
        qt = torch.from_numpy(q.view(np.int64))
        got = lookup_scores(qt.to(dev), smap.arrays(dev))
        chk.same("lookup_scores", [got],
                 [lookup_scores_plain(qt, smap.arrays("cpu"))],
                 f"2^22 k-mers, half stored, {tag}")
    # KB1, canonical: ec chunks, then rows of every kind against maps of
    # their own seeds (0 stored), inline and flat
    for smap, tag in ((td, "-k 25 -t map"), (flat, "flat image")):
        kb1(codes37, len37, 25, 13, True, None, smap, f"ec chunk W=13, {tag}")
    codes40, len40 = _ec_chunk(40)
    kb1(codes40, len40, 21, 16, False, pos21, maps[EC_PHASE2[3][0]],
        "ec chunk -k 21 -S 0x16,1x4 W=16, -S -t map")
    em = kb4(codes37, len37, 25, 13, maps["-C -k 25 -w 37 -t"],
             "ec chunk -C -k 25 W=13, -C -t map")
    say(f"# hash kernels: ec chunk -C -t: {int(em.mask.sum())} minimizers "
        f"of {em.values.shape[1]} slots")
    for mode in ("inline", "flat"):
        for W in (2, 13, 16):
            for k in (25, 32):
                codes, lengths = _hash_rows(rng, k, W)
                smap = _rows_map(rng, codes, lengths, k, True, None, mode)
                kb1(codes, lengths, k, W, True, None, smap,
                    f"rows k={k} W={W} {mode}")
                kb1(*_kb1_edge_rows(rng, k, W), k, W, True, None, smap,
                    f"run and tile edges k={k} W={W} {mode}")
                smap = _rows_map(rng, codes, lengths, k, False, None, mode)
                kb4(codes, lengths, k, W, smap,
                    f"rows -C k={k} W={W} {mode}")
                codes, lengths = _kb1_edge_rows(rng, k, W)
                codes[4, : 2 * KB1_TILE] = -1  # a tile with no valid seed
                lengths[4] = codes.shape[1]
                kb4(codes, lengths, k, W, smap,
                    f"run and tile edges -C k={k} W={W} {mode}")
            for k, pos in ((21, pos21), (32, pos32)):
                codes, lengths = _hash_rows(rng, pos[-1] + 1, W)
                smap = _rows_map(rng, codes, lengths, k, False, pos, mode)
                kb1(codes, lengths, k, W, False, pos, smap,
                    f"rows -S k={k} W={W} {mode} (U64_MAX stored)")
                kb1(*_kb1_edge_rows(rng, pos[-1] + 1, W), k, W, False, pos,
                    smap, f"run and tile edges -S k={k} W={W} {mode}")
    # rows shorter than k and P < W; KB4 twice in a row
    codes, lengths = _short_rows(rng, 3000, 45)
    smap = _rows_map(rng, codes, lengths, 25, True, None, "inline")
    kb1(codes, lengths, 25, 13, True, None, smap, "3000 rows of 45")
    smap = _rows_map(rng, codes, lengths, 25, False, None, "inline")
    kb4(codes, lengths, 25, 13, smap, "3000 rows of 45")
    kb4(codes, lengths, 25, 16, smap, "3000 rows of 45, P < W")
    cases = [_discipline_rows(rng, 25, 13, L=9000, B=16) for _ in range(2)]
    got = [enc.compacted_minimizers(torch.from_numpy(c).to(dev),
                                    torch.from_numpy(n).to(dev), 25, 13,
                                    "hash", maps["-C -k 25 -w 37 -t"])
           for c, n in cases]
    for g, (c, n) in zip(got, cases):
        chk.same("compacted_minimizers_hash", g,
                 enc.compacted_minimizers_plain(
                     torch.from_numpy(c), torch.from_numpy(n), 25, 13, "hash",
                     maps["-C -k 25 -w 37 -t"]), "two calls in a row")
    return flat


def phase_hash(dev, chk, kk, hiseq):
    """9c. The hash-scored phase 2 (build -t|-f --phase1-db) on the card:
    phase-1 maps, the kernels against their plain versions, the ec builds
    and the goldens, classify against a phase-2 database, the timings."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bonsai_tpu_torch import cli, kernels
    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core.spacer import Spacer, parse_spacing
    from bonsai_tpu_torch.db import build_device as bd
    from bonsai_tpu_torch.db.build import content_digest, phase2_content
    from bonsai_tpu_torch.db.formats import Database, load_database
    from bonsai_tpu_torch.db.table import (KmerTable, ScoreMap, lookup_scores,
                                           lookup_scores_plain)
    from bonsai_tpu_torch.taxonomy.tree import TaxTree
    from bonsai_tpu_torch.tools.bounds import (bound_compacted_minimizers,
                                               bound_lookup_scores,
                                               bound_minimizers, hash_queries,
                                               probe_rows, spaced_runs)

    tree = TaxTree.from_nodes_dmp(os.path.join(GOLD, kk["nodes"]))
    genomes = [os.path.join(DATA, "ec", g) for g in kk["genomes"]]
    nameid = os.path.join(GOLD, kk["nameid"])
    # 1. the ec phase-1 maps, as prebuild --device-build builds them
    maps = {}
    for flags, k, _, spacing, canon, phase, want, _ in EC_PHASE2:
        fn = bd.device_taxdepth_map if phase == "t" else bd.device_ftct_map
        t0 = time.perf_counter()
        p1 = fn(genomes, tree, nameid, Spacer(k, k, parse_spacing(spacing, k)),
                canon, device=dev)
        secs = time.perf_counter() - t0
        got = content_digest(p1)
        say(f"# hash: phase 1 of {flags}: {p1.n} k-mers, nb=2^{p1.lgnb} "
            f"({p1.nb * 32 / 2**20:.0f} MiB of slots, "
            f"{'inline' if p1.arrays_np()[2] else 'flat'}) in {secs:.3f}s; "
            f"digest {'matches' if got == want else 'DIFFERS'} the JAX "
            "package's")
        require(got == want, f"phase 1 of {flags} differs")
        maps[flags] = ScoreMap(p1)
    # 2. the kernels against their plain versions
    flat = hash_kernels(dev, chk, maps)
    # 3. the path: the ec builds, the goldens through the CLI
    wrappers = [enc.minimizers, enc.compacted_minimizers, lookup_scores,
                bd.sort_unique, bd.merge_fold]
    reset_counts(wrappers)
    nums, tables = {}, {}
    for flags, k, w, spacing, canon, _, _, want in EC_PHASE2:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        table = bd.device_minimized_map(
            genomes, maps[flags].table, tree, nameid,
            Spacer(k, w, parse_spacing(spacing, k)), canon, device=dev)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = content_digest(table)
        say(f"# hash: ec {flags} --device-build: {table.n} k-mers in "
            f"{secs:.3f}s = {table.n / secs:.6g} k-mers/s; peak device memory "
            f"{peak / 2**20:.1f} MiB; digest "
            f"{'matches' if got == want else 'DIFFERS'} the JAX package's")
        require(got == want, f"ec {flags} phase-2 device build differs")
        nums[flags] = {"secs": secs, "n": table.n, "peak": peak}
        tables[flags] = table
    # the first again by stage, under the profiler
    flags, k, w = EC_PHASE2[0][:3]
    p1 = maps[flags].table
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smap = ScoreMap(p1)
        states, tax, root1 = bd._device_gather(genomes, tree, nameid,
                                               Spacer(k, w), True, 1 << 22,
                                               dev, "hash", smap)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = bd._tree_fold(states, tax, root1)
        n = int(st.n)
        t2 = time.perf_counter()
        keys = st.keys[:n]
        scores = smap.lookup_scores(keys)
        kh = keys.cpu().numpy().view(np.uint64)
        sh = scores.cpu().numpy().view(np.uint64)
        t3 = time.perf_counter()
    del states, st, keys, scores
    keys, vals = phase2_content(kh, p1, sh)
    t4 = time.perf_counter()
    table = KmerTable(keys, vals)
    t5 = time.perf_counter()
    require(content_digest(table) == EC_PHASE2[0][-1], "second build differs")
    busy, top = _device_busy(prof)
    wall = (t3 - t0) * 1e6
    say(f"# hash: ec {flags} again: genomes -> states {t1 - t0:.3f}s, tree "
        f"fold {t2 - t1:.3f}s, KB5 + fetch of {n} keys {t3 - t2:.3f}s, host "
        f"probe of the U64_MAX scores {t4 - t3:.3f}s, table placement (host) "
        f"{t5 - t4:.3f}s; total {t5 - t0:.3f}s")
    say(f"# trace: device busy {busy / 1e3:.3f} ms of {wall / 1e3:.3f} ms "
        f"({100 * busy / wall:.2f}%) in genomes -> states + fold + KB5; top: "
        + "; ".join(f"{k_[:40]} {us / 1e3:.3f} ms" for k_, us in top[:8]))
    nums["again"] = {"gather": t1 - t0, "fold": t2 - t1, "probe": t3 - t2,
                     "host": t4 - t3, "place": t5 - t4, "busy_ms": busy / 1e3,
                     "wall_ms": wall / 1e3}
    m = json.load(open(os.path.join(GOLD, "manifest.json")))
    gold = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                             "g_rand.fa")]
    nodes = os.path.join(GOLD, "nodes.dmp")
    nmap = os.path.join(GOLD, "nameidmap.txt")
    dflags = ["--device-build", "--device", str(dev)]
    runs = [(f"golden {c['name']}", ["-k", "25", f"-{c['phase1']}"],
             c["phase1_digest"], [*c["flags"], f"-{c['phase1']}"],
             c["db_digest"]) for c in m["configs"] if c["phase1"]]
    runs += [(f"{flags} (the JAX CLI's digest)", p1flags.split(), None,
              flags.split(), want)
             for flags, (p1flags, want) in GOLDEN_PHASE2_DIGESTS.items()]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for i, (what, p1flags, p1want, bflags, want) in enumerate(runs):
            p1p, out = (os.path.join(tmp, f"{i}.{x}.btpu") for x in "pq")
            t0 = time.perf_counter()
            require(cli.main(["prebuild", nmap, nodes, p1p, *gold, *p1flags,
                              *dflags]) == 0, f"port CLI prebuild {what}")
            require(cli.main(["build", out, *gold, *bflags, "--phase1-db", p1p,
                              "-T", nodes, "-M", nmap, *dflags]) == 0,
                    f"port CLI build {what}")
            secs = time.perf_counter() - t0
            p1got = content_digest(load_database(p1p).table)
            got = content_digest(load_database(out).table)
            say(f"# hash: {what}: prebuild + build --device-build {secs:.3f}s;"
                f" phase-1 digest {p1got[:12]}, phase-2 digest "
                f"{'matches' if got == want else 'DIFFERS'}")
            require(p1want is None or p1got == p1want, f"{what}: phase 1")
            require(got == want, f"{what}: phase-2 device build differs")
    torch.cuda.synchronize()
    counts = read_counts(wrappers)
    say(f"# hash: kernel launches {counts}")
    for name in (*HASH_ROWS, "sort_unique", "merge_fold"):
        require(counts[name] > 0, f"kernel {name} never launched in phase 2")
    launches = {r: counts[r] for r in HASH_ROWS}
    # 4. classify against a phase-2 database
    db = Database(table=tables[flags], k=k, w=w, gaps=parse_spacing("", k),
                  scheme="hash")
    clf = pl.Classifier(db, tree, emit_all=True, device=dev)
    out = io.StringIO()
    t0 = time.perf_counter()
    clf.process_dataset(hiseq, out, batch_size=8192)
    torch.cuda.synchronize()
    got = hashlib.sha256(out.getvalue().encode()).hexdigest()
    say(f"# hash: HiSeq against the ec {flags} database: "
        f"{out.getvalue().count(chr(10))} lines in "
        f"{time.perf_counter() - t0:.3f}s, sha256 "
        f"{'matches' if got == HISEQ_PHASE2_SHA256 else 'DIFFERS'} the JAX "
        "Classifier's")
    require(got == HISEQ_PHASE2_SHA256, "HiSeq against the phase-2 database "
            "differs from the JAX package")
    del clf, db, tables
    # 5. the four kernels and their plain versions at the builds' shapes
    times, bounds = {}, {}
    pos21 = _positions(21, SPACING21)
    for name, w, k, W, canon, pos, key, tag in (
        ("minimizers_hash", 37, 25, 13, True, None, "-k 25 -w 37 -t",
         "-k 25 -w 37 -t (W = 13)"),
        ("minimizers_spaced_hash", 40, 21, 16, False, pos21,
         EC_PHASE2[3][0], "-k 21 -S 0x16,1x4 -w 40 -t (W = 16)"),
        ("compacted_minimizers_hash", 37, 25, 13, None, None,
         "-C -k 25 -w 37 -t", "-C -k 25 -w 37 -t (W = 13)"),
    ):
        codes, lengths = _ec_chunk(w)
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        smap = maps[key]
        if canon is None:
            def kern(c=c, ln=ln, k=k, W=W, smap=smap):
                return enc.compacted_minimizers(c, ln, k, W, "hash", smap)

            def plain(c=c, ln=ln, k=k, W=W, smap=smap):
                return enc.compacted_minimizers_plain(c, ln, k, W, "hash",
                                                      smap)
        else:
            def kern(c=c, ln=ln, k=k, W=W, canon=canon, pos=pos, smap=smap):
                return enc.minimizers(c, ln, k, W, canon, "hash", pos, smap)

            def plain(c=c, ln=ln, k=k, W=W, canon=canon, pos=pos, smap=smap):
                return enc.minimizers_plain(c, ln, k, W, canon, "hash", pos,
                                            smap)
        probes = probe_rows(hash_queries(c, ln, k, canon, pos),
                            smap.arrays(dev))
        em = kern()
        bounds[name] = (bound_compacted_minimizers(c, ln, em, W,
                                                   probes=probes)
                        if canon is None else
                        bound_minimizers(c, ln, em, W, probes=probes,
                                         runs=spaced_runs(pos) if pos else 0))
        say(f"# hash: {name}: {probes[0]} probes read {probes[1]} slot rows "
            f"({probes[1] / probes[0]:.3f} a probe), {probes[2]} found")
        times[name] = time_pair(name, f"ec chunk {codes.shape[1]} bases {tag}",
                                kern, plain, bounds[name], graph=True)
        lib = kernels.get_lib()
        blocks = (lib.bk_compacted_minimizers_hash_blocks_per_sm(W)
                  if canon is None else
                  lib.bk_minimizers_hash_blocks_per_sm(int(pos is not None),
                                                       pos[-1] + 1 if pos
                                                       else k, W))
        say(f"# hash: {name}: {probes[1]} slot rows in {times[name][0]:.4f} "
            f"ms, {probes[1] / times[name][0] / 1e6:.2f} G rows/s (KB5's "
            f"pattern is the yardstick: lookup_scores below); {blocks} "
            "blocks a SM")
    arr = maps["-k 25 -w 37 -t"].arrays(dev)
    rng = np.random.default_rng(SEED + 10)
    keys = maps["-k 25 -w 37 -t"].table.keys_sorted
    q = np.concatenate([rng.choice(keys, 1 << 21),
                        rng.integers(0, 2**64, 1 << 21, dtype=np.uint64)])
    qt = torch.from_numpy(q.view(np.int64)).to(dev)
    bounds["lookup_scores"] = bound_lookup_scores(qt, arr,
                                                  lookup_scores(qt, arr))
    times["lookup_scores"] = time_pair(
        "lookup_scores", "2^22 k-mers, half stored, the ec -k 25 -t map",
        lambda: lookup_scores(qt, arr), lambda: lookup_scores_plain(qt, arr),
        bounds["lookup_scores"], graph=True)
    del flat, maps
    return launches, times, bounds, nums


def _digest(parts):
    """sha256 of (name + NUL, if any, then the uint64 bytes) of each part,
    in order: the form of the API digests below."""
    import numpy as np

    h = hashlib.sha256()
    for name, a in parts:
        if name is not None:
            h.update(name + b"\0")
        h.update(np.ascontiguousarray(a, np.uint64).tobytes())
    return h.hexdigest()


def _radix_codes(rng, codes4, it):
    """DNA rows of ``_discipline_rows`` / ``_kb1_edge_rows`` as rows of the
    type's codes: each base a random code, T the largest (a row of T folds
    to the largest k-mer: PROTEIN_3BIT at k = 22 to U64_MAX), -1 kept;
    PROTEIN (bytes) also gets bytes past 127 (negative int8, ambiguous)."""
    import numpy as np

    from bonsai_tpu_torch.core.alphabet import radix_of

    hi = 128 if radix_of(it) == 256 else radix_of(it)
    out = rng.integers(0, hi, codes4.shape).astype(np.int8)
    out[codes4 == 3] = hi - 1
    out[codes4 < 0] = -1
    if hi == 128:
        past = (rng.random(codes4.shape) < 0.01) & (codes4 >= 0)
        out[past] = rng.integers(-128, 0, int(past.sum()))
    return out


def _rolling_rows(rng, L, n_chars=4):
    """Rows with 3% Ns, Ns at thread-run and tile edges, an N run longer
    than most k, an all-N row and a row of one code."""
    import numpy as np

    codes = rng.integers(0, n_chars, (6, L)).astype(np.int8)
    codes[rng.random((6, L)) < 0.03] = -1
    for p in (0, KB1_RUN - 1, KB1_RUN, KB1_TILE - 1, KB1_TILE,
              KB1_TILE + KB1_RUN):
        codes[1, p] = -1
    codes[2, KB1_TILE - 300: KB1_TILE + 1200] = -1
    codes[3] = -1
    codes[4] = n_chars - 1
    return codes


def api_kernels(dev, chk, k12, frames):
    """The Python API's instantiations of KB1 and KB4 and KR1 on the card
    against their plain versions on CPU copies, exact: 1M-base slices of
    the K-12 genome and of a protein frame at the API's shapes, then rows
    of every kind (Ns at thread-run and tile edges, N runs longer than
    the span, all-N rows, rows shorter than the span, 0 < n_valid < W
    tails, bytes past 127, a real U64_MAX), KR1 at k = 1, 63, 64, 65 and
    1000."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core import rolling
    from bonsai_tpu_torch.core.alphabet import DNA4, InputType, alphabet_of
    from bonsai_tpu_torch.io import fastx

    rng = np.random.default_rng(SEED + 11)

    def kb1(codes, lengths, k, W, scheme, it, pos, tag):
        name = ("minimizers_spaced_shannon" if it == InputType.DNA else
                "minimizers_radix_shannon" if scheme == "entropy" else
                "minimizers_radix")
        c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
        got = enc.minimizers(c.to(dev), ln.to(dev), k, W, False, scheme, pos,
                             it=it)
        chk.same(name, got, enc.minimizers_plain(c, ln, k, W, False, scheme,
                                                 pos, it=it), tag)

    def kb4(codes, lengths, k, W, scheme, it, canon, tag):
        name = ("compacted_minimizers_shannon" if it == InputType.DNA else
                "compacted_minimizers_radix_shannon" if scheme == "entropy"
                else "compacted_minimizers_radix")
        c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
        got = enc.compacted_minimizers(c.to(dev), ln.to(dev), k, W, scheme,
                                       it=it, canon=canon)
        chk.same(name, got, enc.compacted_minimizers_plain(
            c, ln, k, W, scheme, it=it, canon=canon), tag)

    # 1M-base slices at the API's shapes
    dna = fastx.encode_contig(k12[1_000_000:2_000_000], DNA4.lut)[None, :]
    one = np.array([dna.shape[1]], np.int32)
    pos21, pos12 = _positions(21, SPACING21), _positions(12, "1x11")
    kb4(dna, one, 31, 10, "entropy", InputType.DNA, True,
        "K-12 1M bases -k 31 -w 40 entropy")
    kb4(dna, one, 13, 17, "entropy", InputType.DNA, False,
        "K-12 1M bases -k 13 -w 29 entropy -C")
    kb1(dna, one, 21, 16, "entropy", InputType.DNA, pos21,
        "K-12 1M bases -k 21 -S 0x16,1x4 -w 40 entropy")
    for it, k, W, spacing, scheme in (
            (InputType.PROTEIN20, 7, 1, "", "lex"),
            (InputType.PROTEIN20, 7, 14, "", "entropy"),
            (InputType.PROTEIN_14, 10, 15, "", "lex"),
            (InputType.PROTEIN_6, 12, 8, "1x11", "entropy"),
            (InputType.PROTEIN, 8, 1, "", "lex"),
            (InputType.PROTEIN_3BIT, 22, 1, "", "lex")):
        codes = fastx.encode_contig(frames[0][:1_000_000],
                                    alphabet_of(it).lut)[None, :]
        n = np.array([codes.shape[1]], np.int32)
        tag = f"frame 0, 1M residues {it.name} -k {k} W={W} {scheme}"
        if spacing or W == 1:
            kb1(codes, n, k, W, scheme, it, pos12 if spacing else None, tag)
        else:
            kb4(codes, n, k, W, scheme, it, False, tag)
    # rows of every kind
    for k, pos in ((21, pos21), (32, _positions(32, "1x31"))):
        for W in (2, 13, 16):
            kb1(*_discipline_rows(rng, pos[-1] + 1, W), k, W, "entropy",
                InputType.DNA, pos, f"rows -S k={k} W={W}")
            kb1(*_kb1_edge_rows(rng, pos[-1] + 1, W), k, W, "entropy",
                InputType.DNA, pos, f"run and tile edges -S k={k} W={W}")
    for k in (13, 31, 32):
        for W in (1, 2, 17):
            for canon in (False, True):
                kb4(*_discipline_rows(rng, k, W), k, W, "entropy",
                    InputType.DNA, canon, f"rows k={k} W={W} canon={canon}")
                codes, lengths = _kb1_edge_rows(rng, k, W)
                codes[4, : 2 * KB1_TILE] = -1  # a tile with no valid seed
                lengths[4] = codes.shape[1]
                kb4(codes, lengths, k, W, "entropy", InputType.DNA, canon,
                    f"run and tile edges k={k} W={W} canon={canon}")
    for it in (t for t in InputType if t != InputType.DNA):
        from bonsai_tpu_torch.core.alphabet import nper64

        for k in (1, nper64(it)):
            pos = tuple(range(0, 2 * k - 1, 2))
            for rows in (_discipline_rows(rng, k, 13),
                         _kb1_edge_rows(rng, k, 13)):
                codes = _radix_codes(rng, rows[0], it)
                kb1(codes, rows[1], k, 1, "lex", it, None,
                    f"{it.name} unwindowed rows k={k}")
                for scheme in ("lex", "entropy-file", "entropy"):
                    kb4(codes, rows[1], k, 13, scheme, it, False,
                        f"{it.name} rows k={k} W=13 {scheme}")
            for rows in (_discipline_rows(rng, pos[-1] + 1, 13),
                         _kb1_edge_rows(rng, pos[-1] + 1, 13)):
                codes = _radix_codes(rng, rows[0], it)
                for W in (1, 13):
                    for scheme in ("lex", "entropy-file", "entropy"):
                        kb1(codes, rows[1], k, W, scheme, it, pos,
                            f"{it.name} spaced rows k={k} W={W} {scheme}")
    codes = np.full((2, 200), 7, np.int8)  # PROTEIN_3BIT: U64_MAX k-mers
    codes[1, 100] = -1
    kb1(codes, np.array([200, 180], np.int32), 22, 1, "lex",
        InputType.PROTEIN_3BIT, None, "22 residues of code 7: U64_MAX")
    # KR1
    c = torch.from_numpy(fastx.encode_contig(k12[:1_000_000], DNA4.lut)[None])
    for k, canon in ((31, True), (64, True), (200, False)):
        renc = rolling.RollingEncoder(k, canon)
        chk.same("cyclic_hashes", renc.hashes(c.to(dev)), renc.hashes(c),
                 f"K-12 1M bases k={k}")
    for k in (1, 63, 64, 65, 1000):
        codes = torch.from_numpy(_rolling_rows(rng, 2 * KB1_TILE + 37 + k))
        for canon, nthash in ((False, False), (True, False), (True, True)):
            renc = rolling.RollingEncoder(k, canon, nthash=nthash)
            chk.same("cyclic_hashes", renc.hashes(codes.to(dev)),
                     renc.hashes(codes), f"rows k={k} canon={canon} "
                     f"nthash={nthash}")
        short = codes[:2, :k].contiguous()  # P = 1
        chk.same("cyclic_hashes", renc.hashes(short.to(dev)),
                 renc.hashes(short), f"P = 1, k={k}")
    codes = torch.from_numpy(_rolling_rows(rng, 9000, 20))
    renc = rolling.RollingEncoder(21, n_chars=20)
    chk.same("cyclic_hashes", renc.hashes(codes.to(dev)), renc.hashes(codes),
             "20 characters k=21")
    say(f"# api kernels: "
        f"{ {n: chk.cases[n] for n in API_ROWS} } cases, each exact")


def phase_api(dev, chk):
    """9d. The Python API on the card: term tables, the digests of
    get_kmers, seqdict and rolling_hashes against the JAX package's, the
    new instantiations and KR1 against their plain versions, timings."""
    import numpy as np
    import torch

    from bonsai_tpu_torch import api
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core import rolling
    from bonsai_tpu_torch.core.alphabet import DNA4, InputType, alphabet_of
    from bonsai_tpu_torch.core.entropy import shannon_terms
    from bonsai_tpu_torch.io import fastx
    from bonsai_tpu_torch.tools.bounds import (bound_compacted_minimizers,
                                               bound_cyclic_hashes,
                                               bound_minimizers,
                                               shannon_fp64, spaced_runs)
    from bonsai_tpu_torch.tools.synthetic import translate

    # 1. the Shannon terms: the card's host makes them with its numpy
    for k, want in API_TERMS.items():
        got = hashlib.sha256(shannon_terms(k).tobytes()).hexdigest()
        say(f"# api: terms k={k} sha256 {got[:16]}, the JAX package's host "
            f"{want[:16]}")
        require(got == want, f"the Shannon terms of k={k} differ from the "
                "ones the JAX package's digests were made with (numpy's log "
                "on this host gives other bits): the digests below cannot "
                "match")
    ec = sorted(os.path.join(DATA, "ec", f) for f in os.listdir(
        os.path.join(DATA, "ec")) if f.endswith(".fna.gz"))
    t0 = time.perf_counter()
    records = [(n, s) for p in ec for n, s, _ in fastx.read_fastx(p)]
    k12 = next(iter(fastx.read_fastx(EC_GENOME)))[1]
    frames = [translate(k12, f) for f in range(3)]
    bases = sum(len(s) for _, s in records)
    say(f"# api: {len(records)} records, {bases} bases, read in "
        f"{time.perf_counter() - t0:.1f}s; K-12 frames "
        f"{[len(f) for f in frames]} residues")

    # 2. the main path: every call through the API, counted
    wrappers = [enc.minimizers, enc.compacted_minimizers,
                rolling.cyclic_hashes]
    reset_counts(wrappers)
    got, secs = {}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got[key] = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t

    timed("seqdict -k 31 -w 40", lambda: _digest(
        [(n, a) for p in ec for n, a in api.seqdict(p, k=31, w=40,
                                                    device=dev).items()]))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed("-k 31 -w 40 entropy", lambda: _digest(
            [(n, api.get_kmers(s, k=31, w=40, scheme="entropy", device=dev))
             for n, s in records]))
    busy, top = _device_busy(prof)
    timed("-k 21 -S 0x16,1x4 -w 40 entropy -C", lambda: _digest(
        [(n, api.get_kmers(s, k=21, spacing=SPACING21, w=40,
                           scheme="entropy", canonicalize=False, device=dev))
         for n, s in records]))
    for key, canon in (("K-12 -k 13 -w 29 entropy", True),
                       ("K-12 -k 13 -w 29 entropy -C", False)):
        timed(key, lambda canon=canon: _digest([(None, api.get_kmers(
            k12, k=13, w=29, scheme="entropy", canonicalize=canon,
            device=dev))]))
    for key, it, kw in API_PROTEIN:
        timed(key, lambda it=it, kw=kw: _digest([(None, api.get_kmers(
            f, input_type=InputType[it], device=dev, **kw)) for f in frames]))
    for key, k, canon in (("rolling k=31 canonical", 31, True),
                          ("rolling k=64 canonical", 64, True),
                          ("rolling k=200", 200, False)):
        timed(key, lambda k=k, canon=canon: _digest([(None, api.rolling_hashes(
            k12, k, canon, device=dev))]))
    torch.cuda.synchronize()
    counts = read_counts(wrappers)
    launches = {r: counts[r] for r in API_ROWS}
    for key, want in API_DIGESTS.items():
        say(f"# api: {key}: sha256 {got[key][:16]} "
            f"{'matches' if got[key] == want else 'DIFFERS'} ({secs[key]:.3f}s)")
        require(got[key] == want, f"api {key} differs from the JAX package's")
    say(f"# api: -k 31 -w 40 entropy over the ec corpus: {bases} bases in "
        f"{secs['-k 31 -w 40 entropy']:.3f}s = "
        f"{bases / secs['-k 31 -w 40 entropy'] / 1e6:.2f} Mbases/s; card busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / 1e6 / secs['-k 31 -w 40 entropy']:.2f}%)"
        f": {[(n[:40], round(us / 1e3, 3)) for n, us in top[:4]]}; seqdict "
        f"-k 31 -w 40 (lex) {bases / secs['seqdict -k 31 -w 40'] / 1e6:.2f} "
        f"Mbases/s")
    say(f"# api: kernel launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched by the API")

    # 3. the kernels against their plain versions
    t0 = time.perf_counter()
    api_kernels(dev, chk, k12, frames)
    say(f"# api: the kernels against their plain versions in "
        f"{time.perf_counter() - t0:.1f}s")

    # 4. timings at the K-12 shape (a protein frame for the radix rows)
    t0 = time.perf_counter()
    times, bounds = {}, {}

    def row(s, it=InputType.DNA):
        codes = fastx.encode_contig(s, alphabet_of(it).lut)[None, :]
        return (torch.from_numpy(codes).to(dev),
                torch.tensor([codes.shape[1]], dtype=torch.int32, device=dev))

    dna = row(k12)
    pos21, pos12 = _positions(21, SPACING21), _positions(12, "1x11")
    p20 = row(frames[0], InputType.PROTEIN20)
    p6 = row(frames[0], InputType.PROTEIN_6)
    for name, tag, c, ln, kern, plain, bnd in (
        ("compacted_minimizers_shannon", "K-12 -k 31 -w 40 entropy (W = 10)",
         *dna,
         lambda c, n: enc.compacted_minimizers(c, n, 31, 10, "entropy",
                                               canon=True),
         lambda c, n: enc.compacted_minimizers_plain(c, n, 31, 10, "entropy",
                                                     canon=True),
         lambda c, n, em: bound_compacted_minimizers(
             c, n, em, 10, fp64=shannon_fp64(c, n, 31, 4))),
        ("minimizers_spaced_shannon",
         "K-12 -k 21 -S 0x16,1x4 -w 40 entropy (W = 16)", *dna,
         lambda c, n: enc.minimizers(c, n, 21, 16, False, "entropy", pos21),
         lambda c, n: enc.minimizers_plain(c, n, 21, 16, False, "entropy",
                                           pos21),
         lambda c, n, em: bound_minimizers(
             c, n, em, 16, runs=spaced_runs(pos21),
             fp64=shannon_fp64(c, n, 21, 4, pos21))),
        ("minimizers_radix", "frame 0 PROTEIN20 -k 7 (W = 1)", *p20,
         lambda c, n: enc.minimizers(c, n, 7, 1, False,
                                     it=InputType.PROTEIN20),
         lambda c, n: enc.minimizers_plain(c, n, 7, 1, False,
                                           it=InputType.PROTEIN20),
         lambda c, n, em: bound_minimizers(c, n, em, 1)),
        ("minimizers_radix_shannon",
         "frame 0 PROTEIN_6 -k 12 -S 1x11 -w 30 entropy (W = 8)", *p6,
         lambda c, n: enc.minimizers(c, n, 12, 8, False, "entropy", pos12,
                                     it=InputType.PROTEIN_6),
         lambda c, n: enc.minimizers_plain(c, n, 12, 8, False, "entropy",
                                           pos12, it=InputType.PROTEIN_6),
         lambda c, n, em: bound_minimizers(
             c, n, em, 8, runs=spaced_runs(pos12),
             fp64=shannon_fp64(c, n, 12, 6, pos12))),
        ("compacted_minimizers_radix", "frame 0 PROTEIN20 -k 7 -w 20 (W = 14)",
         *p20,
         lambda c, n: enc.compacted_minimizers(c, n, 7, 14,
                                               it=InputType.PROTEIN20),
         lambda c, n: enc.compacted_minimizers_plain(c, n, 7, 14,
                                                     it=InputType.PROTEIN20),
         lambda c, n, em: bound_compacted_minimizers(c, n, em, 14)),
        ("compacted_minimizers_radix_shannon",
         "frame 0 PROTEIN20 -k 7 -w 20 entropy (W = 14)", *p20,
         lambda c, n: enc.compacted_minimizers(c, n, 7, 14, "entropy",
                                               it=InputType.PROTEIN20),
         lambda c, n: enc.compacted_minimizers_plain(
             c, n, 7, 14, "entropy", it=InputType.PROTEIN20),
         lambda c, n, em: bound_compacted_minimizers(
             c, n, em, 14, fp64=shannon_fp64(c, n, 7, 20))),
    ):
        bounds[name] = bnd(c, ln, kern(c, ln))
        times[name] = time_pair(name, tag, lambda: kern(c, ln),
                                lambda: plain(c, ln), bounds[name],
                                graph=True)
    renc = rolling.RollingEncoder(31, True)
    bounds["cyclic_hashes"] = bound_cyclic_hashes(dna[0], renc.hashes(dna[0]),
                                                  True)
    times["cyclic_hashes"] = time_pair(
        "cyclic_hashes", "K-12 k=31 canonical", lambda: renc.hashes(dna[0]),
        lambda: rolling.cyclic_hashes_plain(dna[0], 31,
                                            *renc.tables(dev)),
        bounds["cyclic_hashes"], graph=True)
    for k, canon in ((64, True), (200, False)):
        r2 = rolling.RollingEncoder(k, canon)
        time_pair("cyclic_hashes", f"K-12 k={k}{' canonical' if canon else ''}",
                  lambda r2=r2: r2.hashes(dna[0]),
                  lambda r2=r2, k=k: rolling.cyclic_hashes_plain(
                      dna[0], k, *r2.tables(dev)),
                  bound_cyclic_hashes(dna[0], r2.hashes(dna[0]), canon),
                  graph=True)
    say(f"# api: timings in {time.perf_counter() - t0:.1f}s")
    return launches, times, bounds, bases / secs["-k 31 -w 40 entropy"] / 1e6


def _cli(argv, cwd):
    """(stdout, stderr) of the port's CLI on ``argv``, run in ``cwd``;
    fails the phase on a non-zero exit."""
    import contextlib

    from bonsai_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        os.chdir(old)
    require(rc == 0, f"{argv[0]}: exit {rc}: {err.getvalue()[-400:]}")
    return out.getvalue(), err.getvalue()


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _shs_bytes(keys):
    """The bytes that write_shs gzips: u64 count, sorted keys."""
    import numpy as np

    return np.uint64(keys.size).tobytes() + keys.tobytes()


def _valid_windows(path, ks):
    """{k: the windows of k bases without an N} over every contig."""
    import numpy as np

    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.io import fastx

    out = dict.fromkeys(ks, 0)
    for _, seq, _ in fastx.read_fastx(path):
        bad = np.concatenate([[0], np.cumsum(
            fastx.encode_contig(seq, DNA4.lut) < 0)])
        for k in ks:
            if bad.size > k:
                out[k] += int((bad[k:] == bad[:-k]).sum())
    return out


def _ulps(got, want):
    """(registers that differ, the most ulp apart) of two f64 arrays of
    non-negative values (+inf allowed)."""
    import numpy as np

    a, b = got.view(np.int64), want.view(np.int64)
    d = np.abs(a - b)
    return int((d != 0).sum()), int(d.max()) if d.size else 0


def phase_sketch(dev, chk):
    """9e. The sketch front-ends on the card: kmercnt's counts,
    rolling-multk, rolling-multk-sketch, setsketch, distmat and cmpshs
    against the JAX package's values, KS4 on the K-12 31-mers; then KS1-KS4
    against their plain versions, timings and bounds."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bonsai_tpu_torch import util
    from bonsai_tpu_torch.core import bitops, hashes, rolling
    from bonsai_tpu_torch.core.bitops import as_keys
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.db import build_device as bd
    from bonsai_tpu_torch.db.build import genome_kmer_set
    from bonsai_tpu_torch.sketch import hll, setsketch as ss, shs

    ec = sorted(os.path.join(DATA, "ec", f) for f in os.listdir(
        os.path.join(DATA, "ec")) if f.endswith(".fna.gz"))
    ecdir = os.path.join(DATA, "ec") + os.sep
    names = [os.path.basename(p) for p in ec]
    # cleared at the end of part 1, or at exit
    tmp_dir = tempfile.TemporaryDirectory(prefix="sketch.",
                                          dir=os.path.join(ROOT, "build"))
    tmp = tmp_dir.name
    t0 = time.perf_counter()
    windows = {p: _valid_windows(p, (17, 21, 25, 29, 31)) for p in ec}
    say(f"# sketch: windows without an N counted on the host in "
        f"{time.perf_counter() - t0:.1f}s")

    # 1. the main path, counted: every subcommand through the port
    wrappers = [hll.hll_fill, ss.csetsketch_update, shs.sort_count,
                bitops.bitmix, bitops.nuccount]
    # KR1 and KB2 run here too; their rows keep the counts of phases 9d
    # and 9, and this path's are required and printed
    shared = [rolling.cyclic_hashes, bd.sort_unique]
    reset_counts(wrappers + shared)
    secs, busy = {}, {}

    def timed(key, fn, prof=False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if prof:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as pr:
                out = fn()
                torch.cuda.synchronize()
            busy[key] = _device_busy(pr)[0]
        else:
            out = fn()
            torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t
        return out

    kmer_prof = None  # the run under the profiler: K-12, canonical ladder
    for mode, ks, canon, nt in SKETCH_MODES:
        hs = {k: hashlib.sha256() for k in ks}
        hb = hashlib.sha256()
        for p in ec:
            def count(p=p):
                ctr = shs.MultiKCounter(ks, canon=canon, nthash=nt, device=dev)
                ctr.add_file(p)
                return ctr.counts()

            key = f"kmercnt {mode} {os.path.basename(p)}"
            if p == EC_GENOME and canon:
                kmer_prof = key
            res = timed(key, count, prof=key == kmer_prof)
            for k, (keys, counts) in zip(ks, res):
                hs[k].update(_shs_bytes(keys))
                if k == 31:
                    hb.update(_shs_bytes(keys) + counts.tobytes())
                n = int(counts.sum(dtype=np.int64))
                require(n == windows[p][k], f"kmercnt {mode} {p} k={k}: the "
                        f"counts sum to {n}, the windows are {windows[p][k]}")
        got = {f"{mode} .{k}.shs": hs[k].hexdigest() for k in ks}
        got[f"{mode} .31.bin"] = hb.hexdigest()
        for key, g in got.items():
            require(g == SKETCH_SHS[key], f"kmercnt {key} differs from the "
                    "JAX package's")
        say(f"# sketch: kmercnt {mode}: {len(got)} sha256s (.shs by k, .31.bin)"
            f" match; counts sum to the windows at every k; "
            f"{sum(secs[f'kmercnt {mode} {n}'] for n in names):.2f}s")
    h = hashlib.sha256()
    for p, name in zip(ec, names):
        timed(f"kmercnt CLI {name}", lambda p=p, name=name: _cli(
            ["kmercnt", p, "-k", "31", "-C", "--shs-only", "-o",
             os.path.join(tmp, name), "--device", dev.type], tmp))
        h.update(_shs_bytes(shs.read_shs(os.path.join(tmp, f"{name}.31.shs"))))
    require(h.hexdigest() == SKETCH_SHS_K31,
            "kmercnt -k 31 -C (CLI) .shs differ from the JAX package's")
    say(f"# sketch: kmercnt -k 31 -C --shs-only CLI: 5 .shs match, "
        f"{sum(secs[f'kmercnt CLI {n}'] for n in names):.2f}s (gzip "
        f"included)")

    out, _ = timed("rolling-multk", lambda: _cli(
        ["rolling-multk", *ec, "--device", dev.type], tmp))
    require(_sha(out.replace(ecdir, "").encode()) == SKETCH_ROLLING[
        "rolling-multk"], f"rolling-multk's text differs: {out[:300]}")
    out, _ = timed("rolling-multk-sketch", lambda: _cli(
        ["rolling-multk-sketch", *ec, "-z", "1024", "--device", dev.type], tmp))
    cards = [float(line.rsplit("~", 1)[1]) for line in out.splitlines()]
    require(len(cards) == len(SKETCH_ROLLING_CARDS) and all(
        abs(c - w) <= 0.05 + 1e-9 * w for c, w in zip(
            cards, SKETCH_ROLLING_CARDS)), "rolling-multk-sketch's "
            f"cardinalities differ: {cards} vs {SKETCH_ROLLING_CARDS}")
    same_text = _sha(out.replace(ecdir, "").encode()) == SKETCH_ROLLING[
        "rolling-multk-sketch text"]
    say(f"# sketch: rolling-multk text matches ({secs['rolling-multk']:.2f}s);"
        f" rolling-multk-sketch -z 1024: 25 cardinalities within 0.05 of "
        f"the JAX package's, text {'identical' if same_text else 'DIFFERS'} "
        f"({secs['rolling-multk-sketch']:.2f}s)")

    ident = 0
    for flags, rows in SKETCH_SETSKETCH.items():
        d = tempfile.mkdtemp(dir=tmp)
        timed(f"setsketch {flags}", lambda flags=flags, d=d: _cli(
            ["setsketch", *ec, *flags.split(), "-B", "-o", "union.ss",
             "--device", dev.type], d), prof=flags == SETSKETCH_MAIN)
        k = flags.split()[flags.split().index("-k") + 1]
        line = []
        for name, (n, ids, idc, regs, card) in zip(names + ["union"], rows):
            f = "union.ss" if name == "union" else f"{name}.{k}.4096.ss"
            s = ss.CSetSketch.read(os.path.join(d, f), device="cpu")
            require(s.n_updates == n, f"setsketch {flags} {name}: n_updates "
                    f"{s.n_updates}, the JAX package's {n}")
            require(_sha(s.ids().tobytes()) == ids,
                    f"setsketch {flags} {name}: ids differ")
            require(idc is None or _sha(s.idcounts().tobytes()) == idc,
                    f"setsketch {flags} {name}: idcounts differ")
            c = s.cardinality()
            require(abs(c - card) <= 1e-9 * card, f"setsketch {flags} "
                    f"{name}: cardinality {c!r}, the JAX package's {card!r}")
            ident += _sha(s.registers.tobytes()) == regs
            line.append(f"{c:.6f} ({card:.6f})")
        say(f"# sketch: setsketch {flags}: ids, idcounts, n_updates match "
            f"for 5 genomes and the union; cardinality (JAX's): "
            f"{', '.join(line)}; {secs[f'setsketch {flags}']:.2f}s")
    say(f"# sketch: setsketch: {ident} of {3 * 6} sketches' registers "
        f"bit-identical to the JAX package's")

    timed("distmat", lambda: _cli(["distmat", *ec, "-k", "31", "-o", "dm",
                                   "--device", dev.type], tmp))
    require(_sha(np.load(os.path.join(tmp, "dm.npy")).tobytes())
            == SKETCH_DISTMAT["npy"], "distmat's matrix differs")
    with open(os.path.join(tmp, "dm.tsv"), "rb") as fh:
        require(_sha(fh.read()) == SKETCH_DISTMAT["tsv"],
                "distmat's .tsv differs")
    timed("distmat --hll 14", lambda: _cli(
        ["distmat", *ec, "-k", "31", "-o", "dmh", "--hll", "14", "--device",
         dev.type], tmp), prof=True)
    got = np.load(os.path.join(tmp, "dmh.npy"))
    want = np.array(SKETCH_DISTMAT["hll"], dtype=np.float32)
    require(_sha(got.tobytes()) == SKETCH_DISTMAT["hll npy"]
            and np.array_equal(got, want), "distmat --hll 14 differs from "
            f"each pair's union_estimate: {got} vs {want}")
    jcli = np.array(SKETCH_DISTMAT["hll JAX CLI"], dtype=np.float32)
    n = len(ec)
    near = [(i, j) for i in range(n) for j in range(i, min(i + 2, n))]
    require(all(got[i, j] == jcli[i, j] for i, j in near),
            "distmat --hll 14 differs from the JAX CLI where it merges "
            "nothing in place")
    far = sum(got[i, j] != jcli[i, j] for i in range(n)
              for j in range(i + 2, n))
    say(f"# sketch: distmat -k 31 matrix and .tsv match "
        f"({secs['distmat']:.2f}s); --hll 14 equals union_estimate of each "
        f"pair, and the JAX CLI on the diagonal and j = i + 1; {far} of "
        f"{(n - 1) * (n - 2) // 2} entries j > i + 1 differ from the JAX "
        f"CLI's merged-in-place ones ({secs['distmat --hll 14']:.2f}s)")

    out, _ = timed("cmpshs", lambda: _cli(
        ["cmpshs", *[f"{name}.31.shs" for name in names], "--device",
         dev.type], tmp))
    require(_sha(out.encode()) == SKETCH_CMPSHS, f"cmpshs differs: {out}")
    say(f"# sketch: cmpshs of the 5 k=31 .shs matches "
        f"({secs['cmpshs']:.2f}s)")
    tmp_dir.cleanup()

    km = genome_kmer_set(EC_GENOME, Spacer(31, 31), True)
    require(km.size == SKETCH_K12_KMERS, f"K-12: {km.size} 31-mers")
    t = as_keys(km, dev)
    got = {
        "wang_hash": hashes.wang_hash(t), "khash_int64_hash":
        hashes.khash_int64_hash(t), "popcount64": bitops.popcount64(t),
        "nuccount": util.nuccount(t, 31), "gccount": util.gccount(t, 31),
        "kmer_entropy": util.kmer_entropy(t, 31)}
    got = {k: _sha(v.cpu().numpy().tobytes()) for k, v in got.items()}
    for key in ("wang_hash", "khash_int64_hash", "popcount64", "nuccount",
                "gccount", "kmer_entropy"):
        require(got[key] == SKETCH_BITMIX[key], f"{key} of the K-12 31-mers "
                "differs from the JAX package's")
    # the inverse mixes and the rotates (library functions: no path of
    # either package calls them)
    inv = {"frev64_inv": hashes.frev64_inv(t),
           "wang_hash_inv": hashes.wang_hash_inv(t),
           "lrot 31": hashes.lrot(t, 31), "rrot 17": hashes.rrot(t, 17)}
    inv = {k: _sha(v.cpu().numpy().tobytes()) for k, v in inv.items()}
    for key, want in SKETCH_INVERSES.items():
        require(inv[key] == want, f"{key} of the K-12 31-mers differs from "
                "the JAX package's")
    say(f"# sketch: K-12 {km.size} 31-mers: wang_hash, khash_int64_hash, "
        f"popcount64, nuccount, gccount, kmer_entropy, frev64_inv, "
        f"wang_hash_inv, lrot 31 and rrot 17 match")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    also = read_counts(shared)
    say(f"# sketch: kernel launches {launches}, and of KR1 and KB2 {also}")
    for name, c in {**launches, **also}.items():
        require(c > 0, f"kernel {name} never launched by the sketches")
    per = {
        "kmercnt": sum(secs[f"kmercnt {SKETCH_MODES[0][0]} {n}"]
                       for n in names) / len(ec),
        "setsketch": secs[f"setsketch {SETSKETCH_MAIN}"] / len(ec),
        "distmat --hll 14": secs["distmat --hll 14"] / len(ec),
    }
    for key in busy:
        say(f"# sketch: {key}: {secs[key]:.3f}s, card busy "
            f"{busy[key] / 1e3:.1f} ms ({busy[key] / 1e4 / secs[key]:.2f}%)")
    say(f"# sketch: wall seconds a genome: {per}")

    # 2. the kernels against their plain versions
    t1 = time.perf_counter()
    stream = sketch_kernels(dev, chk, t)
    say(f"# sketch: the kernels against their plain versions in "
        f"{time.perf_counter() - t1:.1f}s")

    # 3. timings at the shape of one ec genome (K-12), and bounds
    t1 = time.perf_counter()
    times, bounds, library = sketch_numbers(dev, t, *stream)
    say(f"# sketch: timings in {time.perf_counter() - t1:.1f}s")
    return launches, times, bounds, library, per


def _hll_keys(rng, keys, p):
    """keys, with keys whose h << p is 0 (their top p bits only), 0 and
    U64_MAX."""
    import numpy as np
    import torch

    top = (rng.integers(0, 1 << p, size=64).astype(np.uint64)
           << np.uint64(64 - p))
    extra = np.concatenate([top, np.array([0, 2**64 - 1], np.uint64)])
    return torch.cat([keys, torch.from_numpy(extra.view(np.int64))])


def _css_same(chk, what, got, want):
    """KS2: registers within 2 ulp, ids, idcounts and n_updates exact."""
    import numpy as np

    nd, mx = _ulps(got.registers, want.registers)
    require(mx <= 2, f"csetsketch_update {what}: {nd} registers differ, "
            f"up to {mx} ulp")
    require(got.n_updates == want.n_updates, f"csetsketch_update {what}: "
            "n_updates differ")
    if got.save_kmers and want.save_kmers:
        require(np.array_equal(got.ids(), want.ids()),
                f"csetsketch_update {what}: ids differ")
    if got.save_kmer_counts and want.save_kmer_counts:
        require(np.array_equal(got.idcounts(), want.idcounts()),
                f"csetsketch_update {what}: idcounts differ")
    fin = np.isfinite(want.registers)
    err = float(np.abs(got.registers[fin] - want.registers[fin]).max(
        initial=0.0))
    chk.max_err["csetsketch_update"] = max(chk.max_err["csetsketch_update"],
                                           err)
    chk.cases["csetsketch_update"] += 1
    return nd, mx


def _css_guarded(chk, dev, v, save, m=4096):
    """One KS2 launch on ``v`` into a new sketch, its scratch followed by
    2 MiB of a guard pattern that must come back unchanged; the result
    against the plain version's."""
    import torch

    from bonsai_tpu_torch import kernels
    from bonsai_tpu_torch.sketch import setsketch as ss

    n = v.numel()
    used = kernels.get_lib().bk_csetsketch_update_scratch(n, ss.CHUNK, m)
    buf = torch.full((used + (2 << 20),), 0xA5, dtype=torch.uint8,
                     device=dev)
    got = ss.CSetSketch(m, save, save, device=dev)
    want = ss.CSetSketch(m, save, save, device="cpu")
    dv = v.to(dev)
    kernels.launch("bk_csetsketch_update", dev, dv.data_ptr(), n, ss.CHUNK,
                   m, got.regs.data_ptr(), kernels.ptr(got._ids),
                   kernels.ptr(got._idcounts), buf.data_ptr())
    torch.cuda.synchronize()
    got.n_updates = n
    want.update(v)
    bad = int((buf[used:] != 0xA5).sum())
    require(bad == 0, f"csetsketch_update of {n} values wrote {bad} bytes "
            "past its scratch")
    _css_same(chk, f"{n} values, guarded scratch", got, want)


def sketch_kernels(dev, chk, km):
    """KS1-KS4 against their plain versions on CPU copies, with the edge
    cases; returns the K-12 inputs of the timings: the k-mer stream of
    setsketch -k 31 (KB1's emissions, in order) and the k = 31 hash
    stream of MultiKCounter (values, valid)."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.core import bitops, hashes
    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.core.encoder import BatchEncoder
    from bonsai_tpu_torch.core.rolling import RollingEncoder
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.io import fastx
    from bonsai_tpu_torch.sketch import hll, setsketch as ss, shs

    rng = np.random.default_rng(SEED + 9)
    kc = km.cpu()
    edge = torch.from_numpy(np.array(
        [0, 2**64 - 1, 2**63, 2**63 - 1], np.uint64).view(np.int64))
    # KS4
    for name, fn, plain in (
        ("bitmix", hashes.wang_hash, hashes.wang_hash_plain),
        ("bitmix", hashes.khash_int64_hash, hashes.khash_int64_hash_plain),
        ("bitmix", bitops.popcount64, bitops.popcount64_plain),
        ("frev64_inv", hashes.frev64_inv, hashes.frev64_inv_plain),
        ("wang_hash_inv", hashes.wang_hash_inv, hashes.wang_hash_inv_plain),
    ):
        for x in (kc, edge, edge[:1], kc[:0], kc[:1001].reshape(7, 143)):
            chk.same(name, [fn(x.to(dev))], [plain(x)], fn.__name__)
    for r in (0, 1, 31, 32, 63):
        for x in (kc, edge, kc[:1001].reshape(7, 143)):
            chk.same("rotl", [hashes.rotl(x.to(dev), r)],
                     [hashes.rotl_plain(x, r)], f"r={r}")
    for fn, r, want in ((hashes.lrot, 64, lambda x: x),
                        (hashes.rrot, 65, lambda x: hashes.rrot(x, 1)),
                        (hashes.rrot, 17, lambda x: hashes.rrot(x, 17))):
        chk.same("rotl", [fn(kc.to(dev), r)], [want(kc)],
                 f"{fn.__name__} {r}")
    for fwd, inv in ((hashes.frev64, hashes.frev64_inv),
                     (hashes.wang_hash, hashes.wang_hash_inv)):
        chk.same(inv.__name__, [inv(fwd(km))], [kc], "round trip")
    for k in (1, 31, 32):
        x = torch.cat([kc[:200003], edge]) & bitops.i64(
            bitops.kmer_mask_bits(k))
        chk.same("nuccount", [bitops.nuccount(x.to(dev), k)],
                 [bitops.nuccount_plain(x, k)], f"k={k}")
    # KS1: the K-12 31-mers at p = 14 hashed (distmat --hll 14), then
    # p = 4, 14, 16 (shared-memory path) and 17, 20 (global atomics) over a
    # slice with the edge keys
    regs = torch.zeros(1 << 14, dtype=torch.int32)
    dregs = regs.to(dev)
    hll.hll_fill(km, dregs, 14, True)
    hll.hll_fill_plain(kc, regs, 14, True)
    chk.same("hll_fill", [dregs], [regs], "K-12 p=14")
    for p in (4, 14, 16, 17, 20):
        x = _hll_keys(rng, kc[: 1 << 19], p)
        for wang in (False, True):
            regs = torch.zeros(1 << p, dtype=torch.int32)
            dregs = regs.to(dev)
            for _ in range(2):
                hll.hll_fill(x.to(dev), dregs, p, wang)
                hll.hll_fill_plain(x, regs, p, wang)
            chk.same("hll_fill", [dregs], [regs], f"p={p} wang={wang}")
    # KS3: the K-12 k = 31 hash stream, then runs past 65,535, bit 63,
    # E = 0 and 1, twice in a row
    k12 = next(iter(fastx.read_fastx(EC_GENOME)))[1]
    codes = torch.from_numpy(fastx.encode_contig(k12, DNA4.lut)[None, :])
    vals, invalid = RollingEncoder(31).hashes(codes.to(dev))
    hv, hok = vals[0], ~invalid[0]
    chk.same("sort_count", shs.sort_count(hv, hok),
             shs.sort_count_plain(hv.cpu(), hok.cpu()), "K-12 k=31")
    sat = torch.cat([torch.full((70000,), 7), torch.full((65535,), -1),
                     torch.full((65536,), -(1 << 63)), kc[:1000]])
    # past KS3's shared memory: every key in one bucket, one bucket of
    # distinct keys past its capacity, keys below 2^20
    one_bucket = (kc[:300000] & ((1 << 51) - 1)) | (0x5A5 << 51)
    past_cap = torch.cat([kc[:shs.SC_CAP + 5000] & ((1 << 50) - 1),
                          kc[-75000:]])
    small = kc[:200000] & ((1 << 20) - 1)
    for x in (sat, kc[:300000] | -(1 << 63), kc[:0], kc[:1], edge,
              one_bucket, past_cap, small):
        x = x[torch.from_numpy(rng.permutation(x.numel()))]
        em = torch.ones(x.numel(), dtype=torch.bool)
        for _ in range(2):
            chk.same("sort_count", shs.sort_count(x.to(dev), em.to(dev)),
                     shs.sort_count_plain(x, em), f"{x.numel()} keys")
    # KS2: the K-12 k-mer stream of setsketch -k 31 at m = 4096, -S -s and
    # default, against the plain -S -s (the registers do not depend on the
    # mode); then m = 1, 64, 4096 on an empty update, one element, all
    # copies of one k-mer over a chunk of 2^16 + 1 and copies across chunks
    em = BatchEncoder(Spacer(31, 31), True).emissions(
        codes.to(dev), torch.tensor([codes.shape[1]], dtype=torch.int32,
                                    device=dev))
    kstream = em.values[0][em.mask[0]]
    want = ss.CSetSketch(4096, True, True, device="cpu")
    want.update(kstream.cpu())
    report = []
    for save in (True, False):
        got = ss.CSetSketch(4096, save, save, device=dev)
        got.update(kstream)
        report.append(_css_same(chk, f"K-12 -S -s={save}", got, want))
    one = torch.full(((1 << 16) + 1,), 0x1234567890ABCDEF)
    for m in (1, 64, 4096):
        for save, cnt in ((False, False), (True, False), (True, True)):
            got = ss.CSetSketch(m, save, cnt, device=dev)
            want = ss.CSetSketch(m, save, cnt, device="cpu")
            # the copies of one k-mer after the mixed update: against the
            # registers of one element alone, they run ~2,000 rounds
            for v in (kc[:0], kc[:1], torch.cat([kc[:70000],
                                                 kc[:5].repeat(20000)]), one):
                got.update(v.to(dev))
                want.update(v)
                report.append(_css_same(chk, f"m={m} {v.numel()} values",
                                        got, want))
    # a full sketch fed 10 x 2^16 + 3 values, in each mode
    for save, cnt in ((False, False), (True, False), (True, True)):
        got = ss.CSetSketch(4096, save, cnt, device=dev)
        want = ss.CSetSketch(4096, save, cnt, device="cpu")
        for v in (kc[:100000], kc[-(10 * (1 << 16) + 3):]):
            got.update(v.to(dev))
            want.update(v)
        report.append(_css_same(chk, f"full sketch -S={save} -s={cnt}",
                                got, want))
    # KS2 writes nothing past the scratch its size function gives: a guard
    # after it, on updates of fewer values than a chunk and of more
    for n in (1, 3000, (1 << 16) + 1):
        for save in (False, True):
            _css_guarded(chk, dev, kc[:n], save)
    say(f"# sketch: KS2 registers against the plain version: K-12 -S -s "
        f"{report[0][0]} of 4096 differ (up to {report[0][1]} ulp), default "
        f"{report[1][0]} (up to {report[1][1]}); edge cases at most "
        f"{max(r[0] for r in report[2:])} registers, "
        f"{max(r[1] for r in report[2:])} ulp")
    return kstream, hv, hok


def sketch_numbers(dev, km, kstream, hv, hok):
    """KS1-KS4 and their plain versions timed at the K-12 shape, with
    bounds; KS3 in turns beside torch.unique(return_counts=True) and its
    launch alone by graph replay; KS2 in each mode on a new and on a full
    sketch, with the arrivals its bound counts, and under the profiler."""
    import torch

    from torch.profiler import ProfilerActivity, profile

    from bonsai_tpu_torch import kernels
    from bonsai_tpu_torch.core import bitops, hashes
    from bonsai_tpu_torch.core.bitops import SIGN
    from bonsai_tpu_torch.sketch import hll, setsketch as ss, shs
    from bonsai_tpu_torch.tools.bounds import (bound_bitmix, bound_csetsketch,
                                               bound_hll_fill,
                                               bound_sort_count, bound_text,
                                               css_required)
    from bonsai_tpu_torch.tools.gather_bench import graph_ms

    times, bounds, library = {}, {}, {}
    n = km.numel()
    bounds["bitmix"] = bound_bitmix(km, hashes.wang_hash(km))
    times["bitmix"] = time_pair("bitmix", f"wang_hash, K-12 {n} 31-mers",
                                lambda: hashes.wang_hash(km),
                                lambda: hashes.wang_hash_plain(km),
                                bounds["bitmix"], graph=True)
    for name, fn, plain in (
            ("frev64_inv", hashes.frev64_inv, hashes.frev64_inv_plain),
            ("wang_hash_inv", hashes.wang_hash_inv,
             hashes.wang_hash_inv_plain),
            ("rotl", lambda x: hashes.rotl(x, 31),
             lambda x: hashes.rotl_plain(x, 31))):
        bounds[name] = bound_bitmix(km, fn(km))
        times[name] = time_pair(name, f"K-12 {n} 31-mers",
                                lambda: fn(km), lambda: plain(km),
                                bounds[name], graph=True)
    bounds["nuccount"] = bound_bitmix(km, bitops.nuccount(km, 31))
    times["nuccount"] = time_pair("nuccount", f"K-12 {n} 31-mers",
                                  lambda: bitops.nuccount(km, 31),
                                  lambda: bitops.nuccount_plain(km, 31),
                                  bounds["nuccount"], graph=True)
    regs = torch.zeros(1 << 14, dtype=torch.int32, device=dev)
    bounds["hll_fill"] = bound_hll_fill(km, 14, True)
    times["hll_fill"] = time_pair(
        "hll_fill", f"K-12 {n} 31-mers, p=14, wang_hash",
        lambda: hll.hll_fill(km, regs, 14, True),
        lambda: hll.hll_fill_plain(km, regs, 14, True), bounds["hll_fill"],
        graph=True)
    bounds["sort_count"] = bound_sort_count(hv, hok, shs.sort_count(hv, hok))
    times["sort_count"] = time_pair(
        "sort_count", f"K-12 k=31 hash stream, {int(hok.sum())} of "
        f"{hv.numel()} windows", lambda: shs.sort_count(hv, hok),
        lambda: shs.sort_count_plain(hv, hok), bounds["sort_count"])
    # KS3 in turns, by events, each call with its host read of the count:
    # the wrapper, bare torch.unique of the hashes (signed order, no mask:
    # the library time), torch.unique of the flipped emitted hashes (the
    # same function as KS3); then the bk_sort_count launch alone by graph
    # replay (no host read)
    calls = {"KS3": lambda: shs.sort_count(hv, hok),
             "unique": lambda: torch.unique(hv, sorted=True,
                                            return_counts=True),
             "unique of the flipped emitted keys": lambda: torch.unique(
                 hv[hok] ^ SIGN, sorted=True, return_counts=True)}
    turns = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            turns[k].append(time_ms(calls[k], iters=50))
    library["sort_count"] = sum(turns["unique"]) / 2
    E = hv.numel()
    outs = (torch.empty(E, dtype=torch.int64, device=dev),
            torch.empty(E, dtype=torch.int16, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev),
            kernels.scratch("bk_sort_count", E, dev))
    alone = graph_ms(lambda: kernels.launch(
        "bk_sort_count", dev, hv.data_ptr(), hok.data_ptr(), E,
        *(t.data_ptr() for t in outs)))
    say("# time KS3 in turns, events with the host read of n, ms: " +
        "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in v)}"
                  for k, v in turns.items()) +
        f"; KS3 / unique {sum(turns['KS3']) / sum(turns['unique']):.3f}; "
        f"the bk_sort_count launch alone, CUDA-graph replay: {alone:.4f} ms")

    def new(save):
        s = ss.CSetSketch(4096, save, save, device=dev)
        s.update(kstream)

    def full(save):
        s = ss.CSetSketch(4096, save, save, device=dev)
        s.update(kstream)
        parts = [s.regs] + ([s._ids, s._idcounts] if save else [])
        state = [q.clone() for q in parts]

        def call():
            for q, r in zip(parts, state):
                q.copy_(r)
            s.update(kstream)
        return call

    ss.csetsketch_update_plain.arrivals = 0
    ss.csetsketch_update_plain.required = 0
    regs = torch.full((4096,), float("inf"), dtype=torch.float64, device=dev)
    p1 = time_ms(lambda: ss.csetsketch_update_plain(kstream, regs, None,
                                                    None), iters=1, warm=0)
    arrivals = ss.csetsketch_update_plain.arrivals
    required = ss.csetsketch_update_plain.required
    bounds["csetsketch_update"] = bound_csetsketch(kstream, 4096, required)
    # a full sketch: the same stream again into the registers it made
    full_required = css_required(kstream, regs)
    full_bound = bound_csetsketch(kstream, 4096, full_required)
    modes = {"-S -s new": lambda: new(True), "default new": lambda: new(False),
             "-S -s full": full(True), "default full": full(False)}
    ks2 = {k: [] for k in modes}
    for order in (list(modes), list(modes)[::-1]):
        for k in order:
            ks2[k].append(time_ms(modes[k], iters=10, warm=1))
    k1, k2 = ks2["-S -s new"]
    times["csetsketch_update"] = ((k1 + k2) / 2, p1, (k1 + k2) / 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        new(True)
        new(False)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    coop = calls.get("cudaLaunchCooperativeKernel", 0)
    dtoh = sum(c for k, c in calls.items() if "DtoH" in k)
    syncs = calls.get("cudaStreamSynchronize", 0)
    new_bound = bounds["csetsketch_update"][0]
    say(f"# time csetsketch_update K-12 setsketch -k 31 stream ({kstream.numel()}"
        f" values, m=4096), events in turns, ms: " +
        "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in v)}"
                  for k, v in ks2.items()) +
        f" (new: a new sketch a call; full: the sketch of the same stream, "
        f"restored before each call); plain torch on the card (default) "
        f"{p1:.4f} ms; arrivals: the plain version's schedule {arrivals} "
        f"({arrivals / kstream.numel():.2f} a value), required {required} "
        f"({required / kstream.numel():.3f} a value); bound from the "
        f"required: {bound_text(bounds['csetsketch_update'])}; shares "
        f"-S -s new {new_bound / ((k1 + k2) / 2):.2%}, default new "
        f"{new_bound / (sum(ks2['default new']) / 2):.2%}")
    say(f"# KS2 full sketch: required {full_required} arrivals "
        f"({full_required / kstream.numel():.3f} a value, "
        f"csetsketch_update_plain.required from the registers the stream "
        f"made); {bound_text(full_bound)}; shares -S -s full "
        f"{full_bound[0] / (sum(ks2['-S -s full']) / 2):.2%}, default full "
        f"{full_bound[0] / (sum(ks2['default full']) / 2):.2%}")
    say(f"# KS2 under the profiler, one -S -s and one default call on a new "
        f"sketch: cudaLaunchCooperativeKernel {coop}, device-to-host copies "
        f"{dtoh}, cudaStreamSynchronize {syncs}")
    return times, bounds, library


def _timing_calls(mod, names, secs):
    """Wrap ``mod``'s functions ``names`` so that each call's wall seconds
    add to ``secs[name]``; returns the originals, for ``_restore``."""
    orig = {n: getattr(mod, n) for n in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
        return timed

    for n, fn in orig.items():
        setattr(mod, n, wrap(n, fn))
    return orig


def _restore(mod, orig):
    for n, fn in orig.items():
        setattr(mod, n, fn)


def _dir_digests(d):
    return {f: _sha(open(os.path.join(d, f), "rb").read())
            for f in sorted(os.listdir(d))}


def _k12_codes():
    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.io import fastx

    k12 = next(iter(fastx.read_fastx(EC_GENOME)))[1]
    return fastx.encode_contig(k12, DNA4.lut)[None, :]


def _tsha(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_formats(dev, chk, kk, db):
    """9f. Database formats on the card: build --shards 4 and auto and
    --bonsai-format of the ec k=31 database through the port's CLI (KS5
    places the shards), each file's sha256 = the JAX CLI's; classify of
    the sharded directory, of the khash file and of a probe image of the
    .btpu file, each the golden HiSeq sha256; KS5 at the ec keys; K128 and
    the windowed rolling minimizers (KR1, KB4's stream source) of K-12
    against the JAX package's values; then the kernels against their plain
    versions and their timings."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.classify import resolve as rs
    from bonsai_tpu_torch.core import encode128 as e128
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core import rolling
    from bonsai_tpu_torch.core.bitops import as_keys
    from bonsai_tpu_torch.db import formats, table

    genomes = [os.path.join(DATA, "ec", g) for g in kk["genomes"]]
    nodes = os.path.join(GOLD, kk["nodes"])
    hiseq = os.path.join(DATA, kk["sets"]["HiSeq"]["reads"])
    want_hiseq = kk["sets"]["HiSeq"]["sha256"]
    base = ["-k", "31", "-T", nodes, "-M", os.path.join(GOLD, kk["nameid"])]
    tmp_dir = tempfile.TemporaryDirectory(prefix="formats.",
                                          dir=os.path.join(ROOT, "build"))
    tmp = tmp_dir.name
    say(f"# formats: constants pinned from the JAX CLI: {EC_DB_CMD}")

    # 1. the main path, counted
    wrappers = [table.shard_owner, e128.pack_kmers128, e128.rc128,
                enc.compacted_stream]
    shared = [pl.encode_probe, rs.resolve, pl.step_outputs,
              rolling.cyclic_hashes]
    reset_counts(wrappers + shared)
    secs = {}
    orig = _timing_calls(formats, ["save_database_sharded",
                                   "write_bonsai_database",
                                   "load_database_sharded",
                                   "read_bonsai_database"], secs)
    try:
        for flags, want in FORMAT_SHARDS.items():
            out = os.path.join(tmp, flags.split()[1])
            t = time.perf_counter()
            _, err = _cli(["build", out, *genomes, *base, *flags.split()], tmp)
            secs[f"build {flags}"] = time.perf_counter() - t
            if flags.endswith("auto"):
                require("--shards auto -> 1" in err, f"--shards auto: {err}")
            got = _dir_digests(out)
            require(got == want, f"build {flags}: {got} differs from the JAX "
                    f"CLI's {want}")
            say(f"# formats: build {flags}: {len(got)} files match the JAX "
                f"CLI's ({secs[f'build {flags}']:.2f}s, the sharded save "
                f"{secs.pop('save_database_sharded'):.2f}s of it)")
        kh = os.path.join(tmp, "ec.bonsai")
        t = time.perf_counter()
        _cli(["build", kh, *genomes, *base, "--bonsai-format"], tmp)
        secs["build --bonsai-format"] = time.perf_counter() - t
        require(_sha(open(kh, "rb").read()) == FORMAT_KHASH,
                "build --bonsai-format differs from the JAX CLI's")
        say(f"# formats: build --bonsai-format: {os.path.getsize(kh)} bytes "
            f"match the JAX CLI's ({secs['build --bonsai-format']:.2f}s, the "
            f"khash write {secs['write_bonsai_database']:.2f}s of it)")
        btpu = os.path.join(tmp, "auto", "shard-00000.btpu")
        img = os.path.join(tmp, "img")
        t = time.perf_counter()
        _cli(["probe-image", btpu, nodes, img], tmp)
        secs["probe-image"] = time.perf_counter() - t
        for name, path in (("sharded directory (4)", os.path.join(tmp, "4")),
                           ("khash file", kh), ("probe image", img)):
            outp = os.path.join(tmp, "hiseq.out")
            t = time.perf_counter()
            _cli(["classify", path, nodes, hiseq, "-a", "-o", outp], tmp)
            secs[f"classify {name}"] = time.perf_counter() - t
            got = _sha(open(outp, "rb").read())
            require(got == want_hiseq, f"HiSeq against the {name} differs "
                    "from the golden")
            say(f"# formats: classify HiSeq against the {name}: sha256 "
                f"matches ({secs[f'classify {name}']:.2f}s)")
        say(f"# formats: merged load of the 4 shards "
            f"{secs['load_database_sharded']:.2f}s, khash read "
            f"{secs['read_bonsai_database']:.2f}s, probe-image "
            f"{secs['probe-image']:.2f}s")
        # phase 9g classifies the --shards 4 directory a rank at a time
        shards4 = os.path.join(ROOT, "build", "sharded-ec4")
        shutil.rmtree(shards4, ignore_errors=True)
        shutil.move(os.path.join(tmp, "4"), shards4)
    finally:
        _restore(formats, orig)
        tmp_dir.cleanup()

    keys = as_keys(db.table.keys_sorted, dev)
    for ndb, want in FORMAT_OWNERS.items():
        got = _tsha(table.shard_owner(keys, ndb))
        require(got == want, f"KS5 at ndb={ndb} differs from the JAX package")
    say(f"# formats: KS5 owners of the {keys.numel()} ec keys at ndb = "
        f"{sorted(FORMAT_OWNERS)} match the JAX package's")
    codes = torch.from_numpy(_k12_codes()).to(dev)
    t = time.perf_counter()
    for k, (wp, wr, wc) in K128_DIGESTS.items():
        hi, lo, inv = e128.pack_kmers128(codes, k)
        require(_tsha(hi, lo, inv) == wp, f"K128 pack at k={k} differs")
        require(_tsha(*e128.reverse_complement128(hi, lo, k)) == wr,
                f"K128 rc at k={k} differs")
        require(_tsha(*e128.canonical128(hi, lo, k), inv) == wc,
                f"K128 canonical at k={k} differs")
        require(_tsha(*e128.pack_kmers128(codes, k, canon=True)) == wc,
                f"K128 canonical pack at k={k} differs")
    torch.cuda.synchronize()
    say(f"# formats: K128 on K-12 ({codes.shape[1]} bases) at k = "
        f"{sorted(K128_DIGESTS)}: pack, rc, canonical and the canonical pack "
        f"match the JAX package's ({time.perf_counter() - t:.2f}s)")
    lengths = torch.tensor([codes.shape[1]], dtype=torch.int32, device=dev)
    for (k, w, canon), (want, n) in EMISSION_DIGESTS.items():
        t = time.perf_counter()
        v, m = rolling.RollingEncoder(k, canon, w).emissions(codes, lengths)
        got = _tsha(v[m], m)
        require(got == want and int(m.sum()) == n,
                f"emissions k={k} w={w} differ from the JAX package's")
        say(f"# formats: RollingEncoder({k}, canon={canon}, w={w}).emissions "
            f"of K-12: {n} emitted, sha256 matches "
            f"({time.perf_counter() - t:.3f}s)")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    also = read_counts(shared)
    also.pop("encode_probe_spaced")  # no spaced seed here
    say(f"# formats: kernel launches {launches}, and of K1-K3 and KR1 {also}")
    for name, c in {**launches, **also}.items():
        require(c > 0, f"kernel {name} never launched by the formats' path")

    # 2. the kernels against their plain versions
    t = time.perf_counter()
    format_kernels(dev, chk, keys, codes)
    say(f"# formats: the kernels against their plain versions in "
        f"{time.perf_counter() - t:.1f}s")

    # 3. timings at the ec keys and K-12, and bounds
    t = time.perf_counter()
    times, bounds = format_numbers(dev, keys, codes)
    say(f"# formats: timings in {time.perf_counter() - t:.1f}s")
    return launches, times, bounds, secs, shards4


def format_kernels(dev, chk, keys, codes):
    """KS5, K128 and KB4's stream source against their plain versions on
    CPU copies, exactly: KS5 on every ec key, K128 on the whole of K-12
    at k = 64; keys with bit 63 set, 0 and U64_MAX; an all-N row,
    P = 1, Ns at tile and run edges, codes past 3; pairs with bit 63 in
    either lane; W = 1, 37 and 8192, rows shorter than the window, an
    all-invalid row, 0 < n_valid < W."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.core import encode128 as e128
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core import rolling
    from bonsai_tpu_torch.core.encode import position_validity
    from bonsai_tpu_torch.db import table

    rng = np.random.default_rng(SEED + 11)
    edge = torch.from_numpy(np.array([0, 2**64 - 1, 2**63, 2**63 - 1],
                                     np.uint64).view(np.int64))
    # KS5 and rc/canonical run a grid-stride loop over at most sms * 16
    # blocks, so the whole of the main path's inputs go through the
    # later passes: every ec key, and every K-12 pair at k = 64.
    kall = keys.cpu()
    for ndb in (4, 65536):
        chk.same("shard_owner", [table.shard_owner(keys, ndb)],
                 [table.shard_owner_plain(kall, ndb)],
                 f"all {kall.numel()} ec keys ndb={ndb}")
    call = codes.cpu()
    for canon in (False, True):
        chk.same("pack_kmers128", e128.pack_kmers128(codes, 64, canon),
                 e128.pack_kmers128_plain(call, 64, canon),
                 f"K-12 k=64 canon={canon}")
    hi, lo, _ = e128.pack_kmers128(codes, 64)
    hc, lc = hi.cpu(), lo.cpu()
    for name, fn, plain in (
            ("reverse_complement128", e128.reverse_complement128,
             e128.reverse_complement128_plain),
            ("canonical128", e128.canonical128, e128.canonical128_plain)):
        chk.same(name, fn(hi, lo, 64), plain(hc, lc, 64),
                 f"all {hc.numel()} K-12 pairs k=64")
    kc = keys[: 1 << 20].cpu()
    for ndb in (1, 3, 4, 65536, 2**31 - 1):
        for x in (kc, edge, kc[:0], kc[:1], kc[:1001].reshape(7, 143)):
            chk.same("shard_owner", [table.shard_owner(x.to(dev), ndb)],
                     [table.shard_owner_plain(x, ndb)], f"ndb={ndb}")
    c = codes[:, : 1 << 20].cpu().numpy().copy()
    rows = np.repeat(c[:, :3 * 4096 + 111], 6, axis=0)
    rows[1, :] = -1
    rows[2, 15::16] = -1
    rows[3, 4095:4097] = -1
    rows[4, 300:500] = -1
    rows[5, rng.integers(0, rows.shape[1], 30)] = rng.integers(
        4, 128, 30).astype(np.int8)
    for k in (33, 40, 55, 64):
        for canon in (False, True):
            for x in (c, rows, rows[:, :k], rows[:2, : 4096 + k - 1]):
                x = torch.from_numpy(np.ascontiguousarray(x))
                chk.same("pack_kmers128",
                         e128.pack_kmers128(x.to(dev), k, canon),
                         e128.pack_kmers128_plain(x, k, canon),
                         f"k={k} canon={canon} {tuple(x.shape)}")
        hi = torch.cat([edge, edge.flip(0), kc[:200000]])
        lo = torch.cat([edge.flip(0), edge, kc[200000:400000]])
        for name, fn, plain in (
                ("reverse_complement128", e128.reverse_complement128,
                 e128.reverse_complement128_plain),
                ("canonical128", e128.canonical128, e128.canonical128_plain)):
            for h, l in ((hi, lo), (hi[:1], lo[:1]), (hi[:0], lo[:0])):
                chk.same(name, fn(h.to(dev), l.to(dev), k), plain(h, l, k),
                         f"k={k} {h.numel()} pairs")
    renc = rolling.RollingEncoder(64, False, 100)
    x = torch.from_numpy(np.ascontiguousarray(c))
    v, inv = rolling.cyclic_hashes_plain(x, 64, *renc.tables("cpu"))
    ok = position_validity(torch.tensor([x.shape[1]]), v.shape[1], 64) & ~inv
    vals = torch.cat([v[:, :30000]] * 5)
    flags = torch.cat([ok[:, :30000]] * 5)
    vals[0, :5] = torch.cat([edge, edge[:1]])
    flags[1] = False
    flags[2] = False
    for W in (1, 37, 8192):
        f = flags.clone()
        f[2, 50:50 + max(W // 2, 1)] = True
        for a, b in ((vals, f), (vals[:, : W // 2 + 1], f[:, : W // 2 + 1]),
                     (vals[:, :1], f[:, :1]), (v, ok)):
            a, b = a.contiguous(), b.contiguous()
            chk.same("compacted_stream",
                     enc.compacted_stream(a.to(dev), b.to(dev), W),
                     enc.compacted_stream_plain(a, b, W),
                     f"W={W} {tuple(a.shape)}")


def format_numbers(dev, keys, codes):
    """KS5 at the ec keys (ndb = 4), K128 pack, rc and canonical at K-12
    (k = 64) and KB4's stream source at K-12 (k = 64, w = 100), each with
    its plain version, by CUDA-graph replay, with bounds."""
    import torch

    from bonsai_tpu_torch.core import encode128 as e128
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core import rolling
    from bonsai_tpu_torch.core.encode import position_validity
    from bonsai_tpu_torch.db import table
    from bonsai_tpu_torch.tools.bounds import (bound_compacted_stream,
                                               bound_pack_kmers128,
                                               bound_rc128, bound_shard_owner,
                                               bound_text)

    times, bounds = {}, {}
    n = keys.numel()
    bounds["shard_owner"] = bound_shard_owner(keys,
                                              table.shard_owner(keys, 4))
    times["shard_owner"] = time_pair(
        "shard_owner", f"{n} ec keys, ndb=4",
        lambda: table.shard_owner(keys, 4),
        lambda: table.shard_owner_plain(keys, 4), bounds["shard_owner"],
        graph=True)
    P = codes.shape[1] - 63
    for canon in (True, False):  # the uncanonical pack is reported
        out = e128.pack_kmers128(codes, 64, canon)
        bounds["pack_kmers128"] = bound_pack_kmers128(codes, out, canon)
        times["pack_kmers128"] = time_pair(
            "pack_kmers128", f"K-12 {codes.shape[1]} bases k=64 "
            f"canon={canon}", lambda: e128.pack_kmers128(codes, 64, canon),
            lambda: e128.pack_kmers128_plain(codes, 64, canon),
            bounds["pack_kmers128"], graph=True)
    hi, lo, inv = e128.pack_kmers128(codes, 64)
    for name, fn, plain, canon in (
            ("reverse_complement128", e128.reverse_complement128,
             e128.reverse_complement128_plain, False),
            ("canonical128", e128.canonical128, e128.canonical128_plain,
             True)):
        bounds[name] = bound_rc128((hi, lo), fn(hi, lo, 64), canon)
        times[name] = time_pair(
            name, f"K-12 {P} pairs k=64", lambda: fn(hi, lo, 64),
            lambda: plain(hi, lo, 64), bounds[name], graph=True)
    renc = rolling.RollingEncoder(64, False, 100)
    v, invalid = renc.hashes(codes)
    ok = position_validity(torch.tensor([codes.shape[1]], device=dev),
                           v.shape[1], 64) & ~invalid
    bounds["compacted_stream"] = bound_compacted_stream(
        v, ok, enc.compacted_stream(v, ok, 37), 37)
    times["compacted_stream"] = time_pair(
        "compacted_stream", f"K-12 k=64 hash stream {v.shape[1]} values, "
        "W=37", lambda: enc.compacted_stream(v, ok, 37),
        lambda: enc.compacted_stream_plain(v, ok, 37),
        bounds["compacted_stream"], graph=True)
    for name in ("shard_owner", "pack_kmers128", "reverse_complement128",
                 "canonical128", "compacted_stream"):
        say(f"# formats: {name} {times[name][0]:.4f} ms, "
            f"{bound_text(bounds[name])}, share "
            f"{bounds[name][0] / times[name][0]:.3f}")
    return times, bounds


def _sha_run(clf, path, mate=None, batch=8192):
    out = io.StringIO()
    clf.process_dataset(path, out, mate_path=mate, batch_size=batch)
    return _sha(out.getvalue().encode())


def phase_sharded(dev, chk, kk, db, tree, shards4):
    """9g. The sharded classifier and the sharded build on the card, with
    in-process ranks sharing it: a2a at (dp, db) = (1, 4) and (2, 2) and
    psum at (1, 4) over the ec k=31 database (the HiSeq, MiSeq and ec_k12
    golden sha256s), classify --db-shards 1 through the CLI (psum, one
    rank) and --db-shards 4 refused with the JAX CLI's message, the
    paired golden through both routes at db 2, a2a at cf 0.05 (rounds >
    1), phase 9f's --shards 4 directory a rank at a time (db 4 and 2),
    probe-image --db-ranks 4 and its images, a shard rewritten in place
    (stale images ignored), per-rank output joined by merge-parts,
    sharded_lca_map of the ec corpus at db 4 (kraken.db_digest) and the
    sequence-parallel encode of K-12 at sp 4; then each new kernel
    against its plain version and its timing."""
    import numpy as np
    import torch

    from bonsai_tpu_torch import cli
    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.classify import resolve as rs
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.db import build_device as bd
    from bonsai_tpu_torch.db import formats
    from bonsai_tpu_torch.db.build import content_digest
    from bonsai_tpu_torch.parallel import route as rt
    from bonsai_tpu_torch.parallel import sharded as sh
    from bonsai_tpu_torch.parallel.mesh import make_mesh

    sets = {w: (os.path.join(DATA, kk["sets"][w]["reads"]),
                kk["sets"][w]["sha256"]) for w in ("HiSeq", "MiSeq", "ec_k12")}
    hiseq, want_hiseq = sets["HiSeq"]
    nodes = os.path.join(GOLD, kk["nodes"])
    secs = {}
    wrappers = [rt.route_frame, rt.route_probe, rt.route_collect,
                pl.encode_probe, enc.minimizers, bd.key_range]
    shared = [rs.resolve, pl.step_outputs, bd.sort_unique, bd.merge_fold]
    tmp_dir = tempfile.TemporaryDirectory(prefix="sharded.",
                                          dir=os.path.join(ROOT, "build"))
    tmp = tmp_dir.name

    def mesh(dp, n):
        return make_mesh({"dp": dp, "db": n}, [dev])

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t
        return out

    # 1. the main path, counted; KD1 probe's launches split by round (a
    # batch's first round of the a2a route, or a later one)
    reset_counts(wrappers + shared)
    split = {"first": 0, "later": 0}
    a2a_round = sh.ShardedClassifier._a2a_round

    def counted_round(self, st, cap, want_idx):
        n = rt.route_probe.launches
        out = a2a_round(self, st, cap, want_idx)
        split["later" if self.last_rounds else "first"] += (
            rt.route_probe.launches - n)
        return out

    sh.ShardedClassifier._a2a_round = counted_round
    try:
        clfs = {}
        for route, dp, n in (("a2a", 1, 4), ("a2a", 2, 2), ("psum", 1, 4)):
            tag = f"{route} ({dp}, {n})"
            clfs[tag] = clf = timed(f"construct {tag}", lambda: (
                sh.ShardedClassifier(db, tree, mesh(dp, n), route=route,
                                     emit_all=True)))
            for which, (path, want) in sets.items():
                got = timed(f"{which} {tag}", lambda: _sha_run(clf, path))
                require(got == want, f"{which} through {tag} differs from "
                        "the golden")
            say(f"# sharded: {tag}: HiSeq, MiSeq, ec_k12 sha256 match "
                f"(construct {secs[f'construct {tag}']:.2f}s, HiSeq "
                f"{secs[f'HiSeq {tag}']:.2f}s"
                f"{f', {clf.last_rounds} round(s)' if route == 'a2a' else ''})")
        # the stream: HiSeq x 20 through a2a (1, 4), as phase 6's
        a14 = clfs["a2a (1, 4)"]
        secs["stream reads/s a2a (1, 4)"], secs["busy % a2a (1, 4)"] = \
            _sharded_stream(a14, hiseq)
        # overflow rounds: a2a (1, 4) at cf 0.05
        a14.capacity_factor = 0.05
        b = _batch(hiseq, 8192, DNA4.lut)
        a14.classify_batch(b)
        rounds = a14.last_rounds
        got = timed("HiSeq a2a cf 0.05", lambda: _sha_run(a14, hiseq))
        require(rounds > 1 and got == want_hiseq,
                f"a2a at cf 0.05: {rounds} rounds, sha256 "
                f"{'matches' if got == want_hiseq else 'differs'}")
        a14.capacity_factor = 1.05
        say(f"# sharded: a2a (1, 4) at cf 0.05: {rounds} rounds on an 8192-"
            f"read HiSeq batch; HiSeq sha256 matches "
            f"({secs['HiSeq a2a cf 0.05']:.2f}s)")
        # per-rank output, joined by merge-parts
        parts = os.path.join(tmp, "parts")
        timed("distributed a2a (1, 4)", lambda: a14.process_dataset_distributed(
            hiseq, parts, batch_size=8192))
        merged = os.path.join(tmp, "merged.tsv")
        _cli(["merge-parts", parts, "-o", merged], tmp)
        require(_sha(open(merged, "rb").read()) == want_hiseq,
                "merge-parts of the per-rank output differs from the golden")
        say(f"# sharded: process_dataset_distributed (a2a (1, 4), one part) + "
            f"merge-parts: HiSeq sha256 matches")
        del clfs, a14
        # the CLI: --db-shards 1 (psum, one rank); --db-shards 4 refused
        btpu = os.path.join(tmp, "ec.btpu")
        formats.save_database(db, btpu)
        outp = os.path.join(tmp, "cli.tsv")
        timed("CLI --db-shards 1", lambda: _cli(
            ["classify", btpu, nodes, hiseq, "-a", "--db-shards", "1", "-o",
             outp, "--device", str(dev)], tmp))
        require(_sha(open(outp, "rb").read()) == want_hiseq,
                "classify --db-shards 1 differs from the golden")
        err = io.StringIO()
        import contextlib

        with contextlib.redirect_stderr(err):
            rc = cli.main(["classify", btpu, nodes, hiseq, "--db-shards",
                           "4", "--device", str(dev)])
        n_cards = torch.cuda.device_count()
        want_err = f"{n_cards} devices not divisible by db_shards=4"
        require(n_cards % 4 == 0 or (rc == 1 and want_err in err.getvalue()),
                f"--db-shards 4 on {n_cards} card(s): exit {rc}, "
                f"{err.getvalue()[-200:]}")
        say(f"# sharded: CLI --db-shards 1: HiSeq sha256 matches "
            f"({secs['CLI --db-shards 1']:.2f}s); --db-shards 4 on "
            f"{n_cards} card(s): exit {rc}, '{want_err}'")
        # the paired golden through both routes at db 2 (lex_k25)
        m = json.load(open(os.path.join(GOLD, "manifest.json")))
        cfg = next(c for c in m["configs"] if c["name"] == m["classify"]["db"])
        lex = os.path.join(tmp, "lex.btpu")
        _cli(["build", lex, *(os.path.join(GOLD, f) for f in (
            "g_phix.fa", "g_phixmut.fa", "g_rand.fa")), *cfg["flags"], "-T",
            os.path.join(GOLD, "nodes.dmp"), "-M",
            os.path.join(GOLD, "nameidmap.txt")], tmp)
        ldb = formats.load_database(lex)
        from bonsai_tpu_torch.taxonomy.tree import TaxTree

        ltree = TaxTree.from_nodes_dmp(os.path.join(GOLD, "nodes.dmp"))
        with gzip.open(os.path.join(GOLD, "classify_pe.tsv.gz"), "rb") as fh:
            want_pe = _sha(fh.read())
        for route in ("a2a", "psum"):
            clf = sh.ShardedClassifier(ldb, ltree, mesh(1, 2), route=route,
                                       emit_all=True)
            got = _sha_run(clf, os.path.join(GOLD, "mate1.fa"),
                           os.path.join(GOLD, "mate2.fa"))
            require(got == want_pe, f"paired golden through {route} (1, 2) "
                    "differs")
        say("# sharded: paired golden through a2a and psum at (1, 2) matches")
        # phase 9f's --shards 4 directory, a rank at a time
        for n in (4, 2):
            clf = timed(f"from_sharded_dir db {n}", lambda: (
                sh.ShardedClassifier.from_sharded_dir(shards4, tree,
                                                      mesh(1, n),
                                                      emit_all=True)))
            require(not clf._rank_images_used, "images before any were baked")
            require(_sha_run(clf, hiseq) == want_hiseq,
                    f"the --shards 4 directory at db {n} differs")
        timed("probe-image --db-ranks 4", lambda: _cli(
            ["probe-image", shards4, nodes, "--db-ranks", "4"], tmp))
        clf = timed("from_sharded_dir db 4 images", lambda: (
            sh.ShardedClassifier.from_sharded_dir(shards4, tree, mesh(1, 4),
                                                  emit_all=True)))
        require(clf._rank_images_used, "the baked rank images were not used")
        require(_sha_run(clf, hiseq) == want_hiseq,
                "the rank images' HiSeq text differs")
        shard = os.path.join(shards4, "shard-00001.btpu")
        data = open(shard, "rb").read()
        time.sleep(0.01)
        with open(shard, "wb") as fh:  # rebuilt in place
            fh.write(data)
        clf = sh.ShardedClassifier.from_sharded_dir(shards4, tree, mesh(1, 4),
                                                    emit_all=True)
        require(not clf._rank_images_used,
                "images of a shard rewritten in place were used")
        require(_sha_run(clf, hiseq) == want_hiseq,
                "the rewritten directory's HiSeq text differs")
        del clf
        say(f"# sharded: --shards 4 directory at db 4 "
            f"({secs['from_sharded_dir db 4']:.2f}s to load) and db 2 "
            f"({secs['from_sharded_dir db 2']:.2f}s), probe-image --db-ranks "
            f"4 ({secs['probe-image --db-ranks 4']:.2f}s), loaded from the "
            f"images in {secs['from_sharded_dir db 4 images']:.2f}s: HiSeq "
            "sha256 matches; a shard rewritten in place: images ignored")
        # the sharded build: the ec corpus at db 4
        genomes = [os.path.join(DATA, "ec", g) for g in kk["genomes"]]
        torch.cuda.reset_peak_memory_stats()
        table = timed("sharded_lca_map", lambda: bd.sharded_lca_map(
            genomes, tree, os.path.join(GOLD, kk["nameid"]),
            Spacer(kk["k"], kk["k"]), mesh(1, 4)))
        peak = torch.cuda.max_memory_allocated()
        got = content_digest(table)
        require(got == kk["db_digest"], "sharded_lca_map of the ec corpus "
                "differs from kraken.db_digest")
        say(f"# sharded: sharded_lca_map of the ec corpus at db 4: "
            f"{table.n} k-mers, digest matches kraken.db_digest "
            f"({secs['sharded_lca_map']:.2f}s with the table's placement; "
            f"peak device memory {peak / 2**20:.1f} MiB)")
        del table
        # the sequence-parallel encode of K-12 at sp 4
        codes = torch.from_numpy(_k12_codes()).to(dev)
        L = codes.shape[1]
        ln = torch.tensor([L], dtype=torch.int32, device=dev)
        for canon in (True, False):
            kms, ok = timed(f"sp encode canon={canon}", lambda: (
                sh.sharded_encode_contig(codes, 31, make_mesh({"sp": 4},
                                                              [dev]), canon)))
            em = enc.minimizers(codes, ln, 31, 1, canon)
            P = em.values.shape[1]
            require(torch.equal(ok[:, :P], em.mask) and not bool(ok[:, P:].any())
                    and torch.equal(kms[:, :P], torch.where(em.mask, em.values,
                                                            0)),
                    f"sequence-parallel encode canon={canon} differs")
        say(f"# sharded: sharded_encode_contig of K-12 ({L} bases) at sp 4, "
            "canonical and not: equal to the unsharded encode")
        torch.cuda.synchronize()
        launches = read_counts(wrappers, sharded=True)
        for r in ("encode_probe", "encode_probe_spaced",
                  "encode_probe_sparse", "minimizers",
                  "minimizers_spaced", "minimizers_entropy", *HASH_ROWS,
                  *API_ROWS):
            launches.pop(r, None)  # other phases' rows of these wrappers
        also = read_counts(shared)
        say(f"# sharded: kernel launches {launches}, and of K2, K3, KB2, KB3 "
            f"{also}; KD1 probe's {launches['route_probe']} launches by "
            f"round: first {split['first']}, later {split['later']}")
        require(split["first"] + split["later"] == launches["route_probe"],
                "KD1 probe launched outside an a2a round")
        for name, c in launches.items():
            require(c > 0, f"kernel {name} never launched by phase 9g's path")
    finally:
        sh.ShardedClassifier._a2a_round = a2a_round
        tmp_dir.cleanup()
        shutil.rmtree(shards4, ignore_errors=True)

    # 2. the kernels against their plain versions
    t = time.perf_counter()
    inputs = sharded_kernels(dev, chk, db, tree, hiseq, codes)
    say(f"# sharded: the kernels against their plain versions in "
        f"{time.perf_counter() - t:.1f}s")
    # 3. timings at the main path's shapes, and bounds
    t = time.perf_counter()
    times, bounds = sharded_numbers(dev, inputs)
    say(f"# sharded: timings in {time.perf_counter() - t:.1f}s")
    return launches, times, bounds, secs


def _sharded_stream(clf, hiseq):
    """(reads/s of 20 HiSeq passes in one process_dataset, the card's busy
    share of one pass from a profiler trace) through ``clf``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(ROOT, "build", "hiseq_x20_sharded.fa")
    with open(hiseq, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        for _ in range(20):
            fh.write(data)
    sink = open(os.devnull, "w")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            clf.process_dataset(hiseq, sink, batch_size=8192)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = sum(getattr(e, "self_device_time_total", 0)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
        t0 = time.perf_counter()
        clf.process_dataset(path, sink, batch_size=8192, profile=True)
        secs = time.perf_counter() - t0
    finally:
        sink.close()
        os.unlink(path)
    rps = 200000 / secs
    share = 100 * busy / wall_us
    say(f"# sharded: stream through a2a (1, 4), four ranks on this one card "
        f"(no multi-GPU rate): 200000 HiSeq reads in {secs:.3f}s = "
        f"{rps:.6g} reads/s; stages "
        f"{ {k: round(v, 3) for k, v in clf.stage_seconds.items()} }; one "
        f"pass: wall {wall_us / 1e3:.3f} ms, card busy {busy / 1e3:.3f} ms "
        f"({'not measured' if not busy else f'{share:.2f}%'})")
    return rps, share if busy else float("nan")


def _first_round(clf, prep):
    """Rank 0's inputs and outputs of each KD1 launch of the a2a route's
    first round on an 8192-read batch: the classifier's own round
    (``ShardedClassifier._a2a_round``), with the state it started from."""
    ups = clf._uploads(prep)
    st, cap = clf._a2a_start(ups, prep[3])
    s0 = st[0]
    before = [s0[x].clone() for x in ("done", "hit", "cidx", "oidx")]
    _, got = clf._a2a_round(st, cap, False)
    return dict(enc=(*ups[0], prep[3]), cap=cap, kq=s0["kq"],
                done=before[0], valid=s0["valid"], send=got["frame"][0][0],
                slotq=got["frame"][0][1], recv=got["recv"][0],
                arr=clf._arr[0], resp=got["resp"][0], back=got["back"][0],
                recvs=got["recv"], arrs=dict(clf._arr),
                state=before, after=[s0[x] for x in ("done", "hit", "cidx",
                                                     "oidx")],
                left=got["left"][0])


def sharded_kernels(dev, chk, db, tree, hiseq, k12):
    """KD1, K1's encode-only and bucket-range instantiations, the
    key-range mode and KB1's sequence-parallel instantiation against their
    plain versions on CPU copies, exactly: at the main path's shapes (the
    first a2a round of an 8192-read HiSeq batch at (1, 4), a psum rank's
    rows, a chunk of the ec stream, a K-12 block and its halo), and every
    query to one owner, ndb = 3, Q < ndb, 4M queries (many waves of the
    frame's look-back), keys at U64_MAX and at the splitters past one
    grid pass, a taxid of at least 2^31 in the response word, dictionary
    and flat values.  Returns the main path's inputs for the timings."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.db import build_device as bd
    from bonsai_tpu_torch.db.table import KmerTable, ProbeArrays
    from bonsai_tpu_torch.parallel import route as rt
    from bonsai_tpu_torch.parallel import sharded as sh
    from bonsai_tpu_torch.parallel.mesh import make_mesh
    from bonsai_tpu_torch.tools.kernel_ab import later_rounds

    rng = np.random.default_rng(SEED + 12)
    clf = sh.ShardedClassifier(db, tree, make_mesh({"dp": 1, "db": 4}, [dev]))
    prep = clf._prepare_batch(_batch(hiseq, 8192, DNA4.lut))
    r1 = _first_round(clf, prep)
    # the frame: the main path's, one owner, ndb = 3, Q < ndb, 4M queries
    chk.same("route_frame", [r1["send"], r1["slotq"]],
             rt.route_frame_plain(r1["kq"].cpu(), r1["done"].cpu(), 4,
                                  r1["cap"]), "HiSeq first round, rank 0")
    kq = r1["kq"].cpu()
    one = kq[rt.shard_owner_plain(kq, 4) == 2].contiguous()
    big = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, 4_000_000))
    for x, ndb, cap, what in ((one, 4, 700, "every query to one owner"),
                              (kq, 3, 40000, "ndb = 3"),
                              (kq[:2], 4, 1, "Q < ndb"),
                              (big, 4, 1_050_000, "4M queries")):
        d = torch.from_numpy(rng.random(x.numel()) < 0.2)
        chk.same("route_frame", rt.route_frame(x.to(dev), d.to(dev), ndb, cap),
                 rt.route_frame_plain(x, d, ndb, cap), what)
    # the probe: the main path's received frame, then a table of taxids
    # past 2^31, inline and flat, value index and taxid out
    arr_c = ProbeArrays(r1["arr"].slots.cpu(), r1["arr"].vals.cpu(),
                        r1["arr"].inline, r1["arr"].lgnb, r1["arr"].vbits)
    for wi in (False, True):
        chk.same("route_probe", [rt.route_probe(r1["recv"], r1["arr"], wi)],
                 [rt.route_probe_plain(r1["recv"].cpu(), arr_c, wi)],
                 f"HiSeq received frame want_idx={wi}")
    keys = np.unique(rng.integers(0, 2**64, 300000, dtype=np.uint64))
    vals = (rng.integers(2**31, 2**32, keys.size).astype(np.uint64)
            << np.uint64(32)) | rng.integers(0, 2**31, keys.size).astype(
                np.uint64)
    t = KmerTable(keys, vals)
    q = torch.from_numpy(np.concatenate([keys[::2], rng.integers(
        0, 2**64, 150000, dtype=np.uint64)]).view(np.int64))
    for inline in (True, False):
        s_, v_, i_ = t.encode_slots(vals[:1].repeat(keys.size) if inline
                                    else vals, allow_inline=inline)
        a = ProbeArrays.from_numpy(s_, v_, i_, t.lgnb, t.vbits, dev)
        c = ProbeArrays.from_numpy(s_, v_, i_, t.lgnb, t.vbits, "cpu")
        for wi in (False, True):
            got = rt.route_probe(q.to(dev), a, wi)
            chk.same("route_probe", [got], [rt.route_probe_plain(q, c, wi)],
                     f"taxids >= 2^31 inline={inline} want_idx={wi}")
            require(wi or bool((got.cpu() < 0).any()),
                    "no response word carried a taxid >= 2^31")
    # the collect: the main path's returned frame, from the state the
    # round started from
    st_c = [x.cpu().clone() for x in r1["state"]]
    n2 = rt.route_collect_plain(r1["back"].cpu(), r1["slotq"].cpu(), *st_c)
    chk.same("route_collect", r1["after"] + [r1["left"]], st_c + [n2],
             "HiSeq first round, rank 0")
    # two later rounds (kernel_ab.later_rounds): every rank's probe, rank
    # 0's collect
    later = later_rounds(clf, prep)
    for tag, r in later.items():
        for k in sorted(r["recvs"]):
            a = r["arrs"][k]
            a_c = ProbeArrays(a.slots.cpu(), a.vals.cpu(), a.inline, a.lgnb,
                              a.vbits)
            chk.same("route_probe", [r["resp"][k]],
                     [rt.route_probe_plain(r["recvs"][k].cpu(), a_c, False)],
                     f"HiSeq later round ({tag}), rank {k}")
        st_c = [x.cpu().clone() for x in r["state"]]
        n2 = rt.route_collect_plain(r["back"].cpu(), r["slotq"].cpu(), *st_c)
        chk.same("route_collect", r["after"] + [r["left"]], st_c + [n2],
                 f"HiSeq later round ({tag}), rank 0")
    # K1: encode-only on rank 0's reads; the bucket range on each psum rank
    e_in = r1["enc"]
    chk.same("encode_only", pl.encode_only(*e_in, clf.k, clf.canon),
             pl.encode_only_plain(*(None if x is None else x.cpu()
                                    for x in e_in[:3]), e_in[3], clf.k,
                                  clf.canon), "HiSeq 2048 reads")
    del clf
    ps = sh.ShardedClassifier(db, tree, make_mesh({"dp": 1, "db": 4}, [dev]),
                              route="psum")
    pc, nm, ln, lproc = prep.pcodes, prep.nmask, prep.lengths, prep.lproc
    up = [None if x is None else x.to(dev) for x in (pc, nm, ln)]
    for r in range(4):
        a = ps._arr[r]
        ac = ProbeArrays(a.slots.cpu(), a.vals.cpu(), a.inline, a.lgnb,
                         a.vbits, a.row0, a.rows)
        for wi in (False, True):
            chk.same("encode_probe_range",
                     pl.encode_probe(*up, lproc, 31, True, a, wi),
                     pl.encode_probe_plain(pc, nm, ln, lproc, 31, True, ac,
                                           wi), f"psum rank {r} want_idx={wi}")
    range_arr = ps._arr[0]
    del ps
    # the key range: an ec stream chunk's keys and 5M random keys with
    # U64_MAX and the splitters in them, past one grid pass
    codes, lengths = _ec_chunk(31)
    em = enc.minimizers(torch.from_numpy(codes).to(dev),
                        torch.from_numpy(lengths).to(dev), 31, 1, True)
    ck = torch.where(em.mask[0], em.values[0], -1)
    cp = (~em.mask[0]).to(torch.uint8)
    spl = [1 << 60, 1 << 61, 3 << 60]
    rk = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, 5_000_000))
    rk[:6] = torch.tensor([-1, 1 << 60, 1 << 61, 3 << 60, 0, -2])
    rp = torch.from_numpy((rng.random(rk.numel()) < 0.1).astype(np.uint8))
    for x, p, what in ((ck, cp, "ec chunk"), (rk.to(dev), rp.to(dev),
                                              "5M keys")):
        for s in range(4):
            lo = 0 if s == 0 else spl[s - 1]
            hi = spl[s] if s < 3 else (1 << 64) - 1
            chk.same("key_range", [bd.key_range(x, p, lo, hi, s == 3)],
                     [bd.key_range_plain(x.cpu(), p.cpu(), lo, hi, s == 3)],
                     f"{what} rank {s}")
    # KB1's sequence-parallel instantiation: K-12's last block with its
    # (invalid) halo, and its first with the real one
    L = k12.shape[1] // 4
    blocks = [torch.cat([k12[:, :L], k12[:, L:L + 30]], 1),
              torch.cat([k12[:, 3 * L:], torch.full_like(k12[:, :30], -1)],
                        1)]
    for b in blocks:
        b = b.contiguous()
        ln1 = torch.tensor([b.shape[1]], dtype=torch.int32)
        for canon in (True, False):
            got = enc.minimizers(b, ln1.to(dev), 31, 1, canon,
                                 zero_invalid=True)
            want = enc.minimizers_plain(b.cpu(), ln1, 31, 1, canon,
                                        zero_invalid=True)
            chk.same("minimizers_sp", [got.values, got.mask],
                     [want.values, want.mask],
                     f"K-12 block {b.shape[1]} codes canon={canon}")
    torch.cuda.synchronize()
    say(f"# sharded: kernels equal to their plain versions: "
        f"{ {n: chk.cases[n] for n in ('route_frame', 'route_probe', 'route_collect', 'encode_only', 'encode_probe_range', 'key_range', 'minimizers_sp')} } cases")
    return dict(r1=r1, later=later, up=up, prep=prep, range_arr=range_arr,
                chunk=(ck, cp), spl=spl, block=blocks[0].contiguous())


def sharded_numbers(dev, inp):
    """KD1's three launches, K1's encode-only and bucket-range
    instantiations, the key-range pass and KB1's sequence-parallel
    instantiation, each with its plain version, by CUDA-graph replay at
    the main path's shapes, with bounds; no one PyTorch call computes any
    of these functions (library none)."""
    import torch

    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.db import build_device as bd
    from bonsai_tpu_torch.parallel import route as rt
    from bonsai_tpu_torch.tools.bounds import (bound_encode_probe_range,
                                               bound_key_range,
                                               bound_minimizers, bound,
                                               bound_route_collect,
                                               bound_route_frame,
                                               bound_route_probe, bound_text,
                                               nbytes, probe_split)
    from bonsai_tpu_torch.tools.gather_bench import empty_launch, graph_ms

    times, bounds = {}, {}
    r1 = inp["r1"]
    kq, done, cap = r1["kq"], r1["done"], r1["cap"]
    bounds["route_frame"] = bound_route_frame(
        kq, done, rt.route_frame(kq, done, 4, cap))
    times["route_frame"] = time_pair(
        "route_frame", f"{kq.numel()} queries, ndb=4, cap={cap}",
        lambda: rt.route_frame(kq, done, 4, cap),
        lambda: rt.route_frame_plain(kq, done, 4, cap),
        bounds["route_frame"], graph=True)
    # a frame is one graph node: one cooperative launch, no memset
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.route_frame(kq, done, 4, cap)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    coop = calls.get("cudaLaunchCooperativeKernel", 0)
    memsets = sum(c for key, c in calls.items() if "emset" in key)
    say(f"# KD1 frame under the profiler, one call: "
          f"cudaLaunchCooperativeKernel {coop}, memsets {memsets}")
    require(coop == 1 and memsets == 0,
            "KD1's frame is not one cooperative launch without a memset")
    # the round's four probes in turn, each rank's received frame against
    # its sub-table, as the route runs them: one sub-table probed alone
    # keeps its rows in the 50 MB L2 between replays
    recvs, arrs = r1["recvs"], r1["arrs"]
    bounds["route_probe"] = _mean_bound([bound_route_probe(
        recvs[r], arrs[r], rt.route_probe(recvs[r], arrs[r], False))
        for r in sorted(recvs)])
    times["route_probe"] = time_pair(
        "route_probe", f"{[recvs[r].numel() for r in sorted(recvs)]} "
        f"received keys, 4 sub-tables of {arrs[0].slots.shape[0]} rows in "
        "turn", _turns([lambda r=r: rt.route_probe(recvs[r], arrs[r], False)
                        for r in sorted(recvs)]),
        _turns([lambda r=r: rt.route_probe_plain(recvs[r], arrs[r], False)
                for r in sorted(recvs)]),
        bounds["route_probe"], graph=True)
    back, slotq = r1["back"], r1["slotq"]
    routed = int((slotq < back.numel()).sum())
    state = [x.clone() for x in r1["state"]]
    bounds["route_collect"] = bound_route_collect(slotq, state[0], routed)
    times["route_collect"] = time_pair(
        "route_collect", f"{slotq.numel()} queries, {routed} routed",
        lambda: rt.route_collect(back, slotq, *state),
        lambda: rt.route_collect_plain(back, slotq, *state),
        bounds["route_collect"], graph=True)
    # a collect is one graph node too: one launch, no memset
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.route_collect(back, slotq, *state)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    n_launch = sum(c for key, c in calls.items() if key.startswith(
        "cudaLaunch"))
    memsets = sum(c for key, c in calls.items() if "emset" in key)
    say(f"# KD1 collect under the profiler, one call: launches {n_launch}, "
        f"memsets {memsets}")
    require(n_launch == 1 and memsets == 0,
            "KD1's collect is not one launch without a memset")
    # the later rounds (kernel_ab.later_rounds): probe and collect alone
    for tag, r in inp["later"].items():
        rv, ar = r["recvs"], r["arrs"]
        pb = _mean_bound([bound_route_probe(rv[k], ar[k], r["resp"][k])
                          for k in sorted(rv)])
        pt = graph_ms(_turns([lambda k=k: rt.route_probe(rv[k], ar[k], False)
                              for k in sorted(rv)]))
        st = [x.clone() for x in r["state"]]
        n_r = int((r["slotq"] < r["back"].numel()).sum())
        cb = bound_route_collect(r["slotq"], st[0], n_r)
        ct = graph_ms(lambda: rt.route_collect(r["back"], r["slotq"], *st))
        say(f"# KD1 later round ({tag}), graph replay: probe {pt:.4f} ms "
            f"({[rv[k].numel() for k in sorted(rv)]} keys in turn, rank 0 "
            f"{probe_split(rv[0], ar[0])}; {bound_text(pb)}), collect "
            f"{ct:.4f} ms ({n_r} of {r['slotq'].numel()} routed; "
            f"{bound_text(cb)})")
    # the floor of a launch: empty ones at the probe's and collect's grids,
    # and a cooperative one with one grid barrier
    pblocks = -(-recvs[0].numel() // 256)
    cblocks = -(-slotq.numel() // 1024)
    fl = {f"empty {b} blocks": graph_ms(lambda b=b: empty_launch(b, False,
                                                                 dev))
          for b in (1, cblocks, pblocks)}
    fl[f"cooperative {cblocks} blocks, a grid barrier"] = graph_ms(
        lambda: empty_launch(cblocks, True, dev))
    say(f"# KD1 launch floors, graph replay, ms a launch: "
        f"{ {k: round(v, 4) for k, v in fl.items()} }")
    e_in = r1["enc"]
    out = pl.encode_only(*e_in, 31, True)
    bounds["encode_only"] = bound(nbytes(*e_in[:3], *out))
    times["encode_only"] = time_pair(
        "encode_only", f"{e_in[0].shape[0]} HiSeq reads, P={out[0].shape[1]}",
        lambda: pl.encode_only(*e_in, 31, True),
        lambda: pl.encode_only_plain(*e_in, 31, True), bounds["encode_only"],
        graph=True)
    up, lproc, a = inp["up"], inp["prep"][3], inp["range_arr"]
    out = pl.encode_probe(*up, lproc, 31, True, a, True)
    kmers, valid = pl.encode_only(*up, lproc, 31, True)
    bounds["encode_probe_range"] = bound_encode_probe_range(
        up, a.vals, out, kmers[valid], a)
    times["encode_probe_range"] = time_pair(
        "encode_probe_range", f"8192 HiSeq reads, rows {a.row0}..."
        f"{a.row0 + a.rows} of {1 << a.lgnb}",
        lambda: pl.encode_probe(*up, lproc, 31, True, a, True),
        lambda: pl.encode_probe_plain(*up, lproc, 31, True, a, True),
        bounds["encode_probe_range"], graph=True)
    ck, cp = inp["chunk"]
    lo, hi = inp["spl"][0], inp["spl"][1]
    bounds["key_range"] = bound_key_range(ck, cp, bd.key_range(ck, cp, lo, hi,
                                                                False))
    # four copies of the chunk in turn: 4 x 42 MB exceed the 50 MB L2, so
    # each call reads its chunk from HBM, as the bound counts it (one chunk
    # replayed alone stays in L2)
    copies = [(ck.clone(), cp.clone()) for _ in range(4)]
    times["key_range"] = time_pair(
        "key_range", f"ec chunk of {ck.numel()} keys, rank 1, 4 copies in "
        "turn", _turns([lambda k=k, p=p: bd.key_range(k, p, lo, hi, False)
                        for k, p in copies]),
        _turns([lambda k=k, p=p: bd.key_range_plain(k, p, lo, hi, False)
                for k, p in copies]),
        bounds["key_range"], graph=True)
    b = inp["block"].to(dev)
    ln = torch.tensor([b.shape[1]], dtype=torch.int32, device=dev)
    bounds["minimizers_sp"] = bound_minimizers(
        b, ln, enc.minimizers(b, ln, 31, 1, True, zero_invalid=True), 1)
    times["minimizers_sp"] = time_pair(
        "minimizers_sp", f"K-12 block + halo, {b.shape[1]} codes, k=31",
        lambda: enc.minimizers(b, ln, 31, 1, True, zero_invalid=True),
        lambda: enc.minimizers_plain(b, ln, 31, 1, True, zero_invalid=True),
        bounds["minimizers_sp"], graph=True)
    for name in times:
        say(f"# sharded: {name} {times[name][0]:.4f} ms, "
            f"{bound_text(bounds[name])}, share "
            f"{bounds[name][0] / times[name][0]:.3f}")
    return times, bounds


def phase_gather(dev):
    """python -m bonsai_tpu_torch.tools.gather_bench's run, counted."""
    import torch

    from bonsai_tpu_torch.tools import gather_bench as gb

    wrappers = [gb.row_gather, gb.take_along]
    for w in wrappers:
        w.launches = 0
    res = gb.run(dev, SEED, say=say)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    say(f"# gather: kernel launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched by the gather bench")
    return launches, res


def phase_gather_numbers(dev):
    """Bounds of G1 and G2 at the shapes the gather bench times, and the
    library call that computes each: index_select for G1 (CUDA events, as
    G1), gather for G2 (CUDA-graph replay, as G2)."""
    import torch

    from bonsai_tpu_torch.tools import gather_bench as gb
    from bonsai_tpu_torch.tools.bounds import bound, nbytes

    bounds, library = {}, {}
    tbl, idx = gb.f_case(dev, SEED)
    out = gb.row_gather(tbl, idx)
    bounds["row_gather"] = bound(nbytes(idx) + 2 * nbytes(out))
    library["row_gather"] = time_ms(lambda: torch.index_select(tbl, 0, idx))
    del tbl, out
    name, tab, ix, axis = gb.take_cases(dev)[0]
    ix64 = ix.to(torch.int64)
    bounds["take_along"] = bound(nbytes(tab, ix, gb.take_along(tab, ix, axis)))
    library["take_along"] = gb.graph_ms(lambda: torch.gather(tab, axis, ix64))
    say(f"# time index_select at G1's variant F shape "
        f"{library['row_gather']:.4f} ms (bound {bounds['row_gather'][0]:.4f}); "
        f"gather at G2's {name} {library['take_along'] * 1e3:.3f} us under "
        f"graph replay (bound {bounds['take_along'][0] * 1e3:.3f} us)")
    return bounds, library


def _turns(calls):
    """One callable that makes the next of ``calls`` each time, in turn."""
    import itertools

    nxt = itertools.cycle(calls)
    return lambda: next(nxt)()


def _mean_bound(bs):
    """The bound of one call on average over calls made in turn, from
    each call's ``bound``."""
    tb = sum(b[2] for b in bs) / len(bs)
    to = sum(b[3] for b in bs) / len(bs)
    return (max(tb, to), "bytes" if tb >= to else "operations", tb, to)


def time_pair(name, tag, kern, plain, bnd, graph=False):
    """(kernel ms, plain ms, event ms) of ``kern`` and its plain version,
    in turns plain, kernel, kernel, plain, and a line with the bound
    ``bnd``.  The kernels over 100 calls: 5 calls of a 30 us kernel time
    the card's clocks more than the kernel.  With ``graph`` (a few tens of
    us a call) both are timed by CUDA-graph replay and the events around
    back-to-back calls stand beside them."""
    from bonsai_tpu_torch.tools.bounds import bound_text
    from bonsai_tpu_torch.tools.gather_bench import graph_ms

    if graph:
        p1 = graph_ms(plain, calls=5)
        k1, k2 = graph_ms(kern), graph_ms(kern)
        p2 = graph_ms(plain, calls=5)
        ev = time_ms(kern, iters=100)
    else:
        p1 = time_ms(plain, iters=5, warm=1)
        k1 = ev = time_ms(kern, iters=100)
        k2 = time_ms(kern, iters=100)
        p2 = time_ms(plain, iters=5, warm=1)
    say(f"# time {name} {tag}{', CUDA-graph replay' if graph else ''}: "
        f"kernel {k1:.4f}, {k2:.4f} ms, plain torch on the card "
        f"{p1:.4f}, {p2:.4f} ms; events around back-to-back calls "
        f"{ev:.4f} ms; {bound_text(bnd)}")
    return ((k1 + k2) / 2, (p1 + p2) / 2, ev)


def phase_build_numbers(dev, kk):
    """KB1-KB3 vs their plain versions on the card, at the build's shapes,
    with each kernel's bound and, for KB2, torch.unique's time."""
    import numpy as np
    import torch

    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.db import build_device as bd
    from bonsai_tpu_torch.taxonomy.tree import TaxTree
    from bonsai_tpu_torch.tools.bounds import (bound,
                                               bound_compacted_minimizers,
                                               bound_merge_fold,
                                               bound_minimizers, nbytes,
                                               spaced_runs)

    times, bounds, library = {}, {}, {}

    def pair(name, tag, kern, plain, graph=False):
        return time_pair(name, tag, kern, plain, bounds[name], graph)

    chunks = {}  # KB2's inputs: KB1's output at three build shapes
    for w in (40, 31):  # the main path's k = 31 shape last: it is reported
        codes, lengths = _ec_chunk(w)
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        W = w - 30
        chunks[f"k=31 W={W}"] = enc.minimizers(c, ln, 31, W, True)
        bounds["minimizers"] = bound_minimizers(c, ln, chunks[f"k=31 W={W}"],
                                                W)
        times["minimizers"] = pair(
            "minimizers", f"ec chunk {codes.shape[1]} bases k=31 W={W}",
            lambda: enc.minimizers(c, ln, 31, W, True),
            lambda: enc.minimizers_plain(c, ln, 31, W, True), graph=True)
    # KB1's other instantiations and KB4 at the ec builds' shapes
    pos21 = _positions(21, SPACING21)
    for name, w, tag, kern, plain, bnd in (
        ("minimizers_spaced", 25, "-k 21 -S 0x16,1x4 (W = 1)",
         lambda c, n: enc.minimizers(c, n, 21, 1, False, "lex", pos21),
         lambda c, n: enc.minimizers_plain(c, n, 21, 1, False, "lex", pos21),
         lambda c, n, em: bound_minimizers(c, n, em, 1,
                                           runs=spaced_runs(pos21))),
        ("minimizers_spaced -e", 40, "-k 21 -S 0x16,1x4 -w 40 -e (W = 16)",
         lambda c, n: enc.minimizers(c, n, 21, 16, False, "entropy-file",
                                     pos21),
         lambda c, n: enc.minimizers_plain(c, n, 21, 16, False,
                                           "entropy-file", pos21),
         lambda c, n, em: bound_minimizers(c, n, em, 16,
                                           runs=spaced_runs(pos21),
                                           entropy=True)),
        ("minimizers_entropy", 37, "-k 25 -w 37 -e (W = 13)",
         lambda c, n: enc.minimizers(c, n, 25, 13, True, "entropy-file"),
         lambda c, n: enc.minimizers_plain(c, n, 25, 13, True,
                                           "entropy-file"),
         lambda c, n, em: bound_minimizers(c, n, em, 13, entropy=True)),
        ("compacted_minimizers -e", 37, "-C -k 25 -w 37 -e (W = 13)",
         lambda c, n: enc.compacted_minimizers(c, n, 25, 13, "entropy-file"),
         lambda c, n: enc.compacted_minimizers_plain(c, n, 25, 13,
                                                     "entropy-file"),
         lambda c, n, em: bound_compacted_minimizers(c, n, em, 13, True)),
        ("compacted_minimizers", 40, "-C -k 31 -w 40 (W = 10)",
         lambda c, n: enc.compacted_minimizers(c, n, 31, 10),
         lambda c, n: enc.compacted_minimizers_plain(c, n, 31, 10),
         lambda c, n, em: bound_compacted_minimizers(c, n, em, 10)),
    ):
        codes, lengths = _ec_chunk(w)
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        bounds[name] = bnd(c, ln, kern(c, ln))
        times[name] = pair(name, f"ec chunk {codes.shape[1]} bases {tag}",
                           lambda: kern(c, ln), lambda: plain(c, ln),
                           graph=True)
    codes, lengths = _ec_chunk(25)
    chunks["k=25 W=1 (top digit's pass skipped)"] = enc.minimizers(
        torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev),
        25, 1, True)
    for tag in ("k=31 W=10", "k=25 W=1 (top digit's pass skipped)",
                "k=31 W=1"):  # the main path's k = 31 W = 1 last: reported
        keys, mask = chunks[tag].values[0], chunks[tag].mask[0]
        cap = 1 << (keys.shape[0] - 1).bit_length()
        bounds["sort_unique"] = bound(nbytes(keys, mask,
                                             *bd.sort_unique(keys, mask)))
        times["sort_unique"] = pair(
            "sort_unique", f"ec chunk {tag}: {int(mask.sum())} keys of "
            f"{keys.shape[0]} windows",
            lambda: bd.sort_unique(keys, mask),
            lambda: bd.sort_unique_plain(keys, mask, cap))
        library["sort_unique"] = time_ms(
            lambda: torch.unique(keys, sorted=True), iters=100)
        say(f"# time torch.unique of the same {keys.shape[0]} keys (no "
            f"mask, signed order): {library['sort_unique']:.4f} ms")
    rng = np.random.default_rng(SEED + 3)
    tree = TaxTree.from_nodes_dmp(os.path.join(GOLD, kk["nodes"]))
    pool = np.concatenate([tree.tax_ids, [0]]).astype(np.uint32)
    n, keys = 3 << 20, _key_pool(rng, 5 << 20)
    a = bd.State.from_numpy(*_random_state(rng, keys, n, 1 << 22, pool, tree),
                            n, dev)
    b = bd.State.from_numpy(*_random_state(rng, keys, n, 1 << 22, pool, tree),
                            n, dev)
    tax = tree.device_arrays(dev)
    root1 = int(tree.compact(np.array([1], dtype=np.uint32))[0])
    bounds["merge_fold"] = bound_merge_fold(
        a, b, n, n, tax, bd.merge_fold(a, b, tax, root1, True))
    times["merge_fold"] = pair(
        "merge_fold", "2^22 + 2^22 states, 3M valid each, sum_counts",
        lambda: bd.merge_fold(a, b, tax, root1, True),
        lambda: bd.merge_fold_plain(a, b, tax, root1, True))
    return times, bounds, library


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "bonsai_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(bonsai_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t_all = time.perf_counter()
    dev, card = phase("1 device", phase_device)
    import torch

    from bonsai_tpu_torch.classify.pipeline import Classifier
    from bonsai_tpu_torch.core.alphabet import DNA4

    phase("2 build", phase_build)
    import numpy as np

    from bonsai_tpu_torch.tools.synthetic import deep_tree

    deep = phase("3 deep tree", deep_tree, np.random.default_rng(SEED + 6))
    say(f"# deep tree: {deep.tin.size} nodes, depth {deep.max_depth}, "
        f"{deep.lift.shape[0]} lift levels")
    kk = json.load(open(os.path.join(GOLD, "manifest.json")))["kraken"]
    db, tree, digest, host_secs = phase("4 database", build_ec,
                                        os.path.join(GOLD, kk["nodes"]), kk)
    torch.cuda.reset_peak_memory_stats()
    clf = Classifier(db, tree, emit_all=True, device=dev)
    chk = phase("3 kernels", phase_kernels, dev, clf, DNA4.lut, deep)
    say(f"# database: content sha256 {digest}: "
        f"{'matches' if digest == kk['db_digest'] else 'DIFFERS'}; on the "
        f"card as {clf.arr.slots.numel() * 8 / 2**20:.0f} MiB of slots")
    require(digest == kk["db_digest"], "ec database content differs")
    launches = phase("5 classify", phase_main_path, clf, kk, dev)
    hiseq = os.path.join(DATA, kk["sets"]["HiSeq"]["reads"])
    times, bounds, rps, rows = phase("6 numbers", phase_numbers, dev, clf,
                                     hiseq, deep)
    del clf, deep
    qps = phase("7 scale", phase_scale, dev)
    peak = torch.cuda.max_memory_allocated()
    say(f"# peak device memory allocated (classify, scale): "
        f"{peak / 2**20:.1f} MiB")
    phase("8 build kernels", phase_build_kernels, dev, chk, kk)
    build_launches, build_nums, spaced_table = phase(
        "9 device build", phase_device_build, dev, kk, host_secs)
    spaced_launches, times["encode_probe_spaced"], bounds[
        "encode_probe_spaced"] = phase("5b spaced classify",
                                       phase_spaced_classify, dev, chk, kk,
                                       spaced_table, hiseq)
    del spaced_table
    hash_launches, hash_times, hash_bounds, hash_nums = phase(
        "9c hash-scored phase 2", phase_hash, dev, chk, kk, hiseq)
    times.update(hash_times)
    bounds.update(hash_bounds)
    api_launches, api_times, api_bounds, api_mbps = phase(
        "9d Python API", phase_api, dev, chk)
    times.update(api_times)
    bounds.update(api_bounds)
    sketch_launches, sketch_times, sketch_bounds, sketch_library, per = phase(
        "9e sketches", phase_sketch, dev, chk)
    times.update(sketch_times)
    bounds.update(sketch_bounds)
    format_launches, format_times, format_bounds, format_secs, shards4 = \
        phase("9f formats", phase_formats, dev, chk, kk, db)
    times.update(format_times)
    bounds.update(format_bounds)
    sharded_launches, sharded_times, sharded_bounds, sharded_nums = phase(
        "9g sharded", phase_sharded, dev, chk, kk, db, tree, shards4)
    times.update(sharded_times)
    bounds.update(sharded_bounds)
    del db
    gather_launches, gres = phase("10 gather", phase_gather, dev)
    build_times, build_bounds, library = phase("11 numbers",
                                               phase_build_numbers, dev, kk)
    times.update(build_times)
    bounds.update(build_bounds)
    gather_bounds, gather_library = phase("11 gather numbers",
                                          phase_gather_numbers, dev)
    bounds.update(gather_bounds)
    library.update(gather_library)
    library.update(sketch_library)
    times["row_gather"] = (gres["row_gather"]["ms"],
                           gres["row_gather"]["plain_ms"],
                           gres["row_gather"]["ms"])
    first = next(iter(gres["take_along"].values()))
    times["take_along"] = (first["ms"], first["plain_ms"], first["event_ms"])
    launches.update(build_launches)
    launches.update(spaced_launches)
    launches.update(gather_launches)
    launches.update(hash_launches)
    launches.update(api_launches)
    launches.update(sketch_launches)
    launches.update(format_launches)
    launches.update(sharded_launches)
    # K1's slot rows at G1's random 32-B row rate from a table of the ec
    # table's size (128 MiB): a yardstick, not a bound, since K1 reads its
    # rows faster than G1 does (why is not measured)
    ns = next(c["ns_per_row"] for c in gres["cliff"] if c["table_MiB"] == 128)
    say(f"# K1 at G1's row rate: {rows} slot rows at G1's {1 / ns:.4g} G rows/s "
        f"(random 32-B rows, 128 MiB table) = {rows * ns / 1e6:.4f} ms; K1 "
        f"{times['encode_probe'][0]:.4f} ms, "
        f"{100 * rows * ns / 1e6 / times['encode_probe'][0]:.0f}% of it")
    ec = build_nums[31]
    say(f"# {card}: HiSeq stream {rps:.6g} reads/s; scale probe "
        f"{qps:.6g} queries/s; ec k=31 device build {ec['secs']:.3f}s "
        f"(first), {build_nums['again']['secs']:.3f}s (again), host build "
        f"{host_secs:.3f}s; ec -k 25 -w 37 -t phase 2 "
        f"{hash_nums[EC_PHASE2[0][0]]['secs']:.3f}s; API get_kmers -k 31 -w 40 "
        f"entropy over the ec corpus {api_mbps:.2f} Mbases/s; sketches, wall "
        f"seconds a genome: { {k: round(v, 3) for k, v in per.items()} }; "
        f"formats, wall seconds: "
        f"{ {k: round(v, 3) for k, v in format_secs.items()} }; sharded "
        f"(ranks sharing this one card: no multi-GPU rate): "
        f"{ {k: round(v, 3) for k, v in sharded_nums.items()} }, the "
        f"one-device stream {rps:.6g} reads/s; total "
        f"{time.perf_counter() - t_all:.1f}s")
    say(f"# phases, wall seconds: "
        f"{ {n: round(t, 1) for n, t in PHASE_SECS.items()} }")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": chk.max_err[name],
         "ms": times[name][0], "event_ms": times[name][2],
         "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "share": bounds[name][0] / times[name][0],
         "library_ms": library.get(name)}
        for name, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
