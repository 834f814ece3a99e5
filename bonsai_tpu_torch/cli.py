"""Command line of the PyTorch/CUDA port: ``build``, ``prebuild``,
``classify``, the sketch front-ends and the index and taxonomy tools.

Flags follow ``bonsai_tpu/cli.py`` (and the reference ``bonsai``
subcommands, bin/bonsai.cpp) for the ported slice:

  build OUT GENOMES... -k K [-w W] [-S SPACING] [-e] -T nodes.dmp
        -M nameidmap [-C] [-z] [-F paths] [-t|-f --phase1-db P1]
        [--shards N|auto | --bonsai-format] [--device-build]
        [--device cuda|cpu]
  prebuild NAMEIDMAP nodes.dmp OUT GENOMES... -k K [-S SPACING] [-C]
        [-t|-f] [-F paths] [--device-build] [--device cuda|cpu]
  -v|--version
  classify DB nodes.dmp READS [MATE] [-a] [-f] [-k|-K] [-C] [-o OUT]
           [-c CHUNK] [--profile] [--trace-dir DIR] [--device cuda|cpu]
           [--db-shards N [--route auto|a2a|psum]] [--distributed]
  probe-image DB nodes.dmp OUT_DIR | probe-image SHARDED_DIR nodes.dmp
           [--db-ranks N]
  merge-parts PARTS_DIR [-o OUT]
  kmercnt GENOMES... [-k KS] [-o PREFIX] [-C] [--shs-only|--bin-only]
          [--nthash] [--device cuda|cpu]
  rolling-multk GENOMES... [-k KS] [-C] [--device cuda|cpu]
  rolling-multk-sketch GENOMES... [-k KS] [-z SIZE] [-C] [-o PREFIX]
          [--device cuda|cpu]
  setsketch GENOMES... [-k K] [-o OUT] [-z SIZE] [-C] [-s] [-S] [-Z] [-B]
          [-F paths] [-c] [-P] [--device cuda|cpu]
  distmat GENOMES... -k K -o PREFIX [--metric M] [--hll P] [-C]
          [--device cuda|cpu]
  cmpshs SHS... [-m METRIC] [-o OUT] [--device cuda|cpu]
  css2ss IN OUT [-b BITS] [--device cuda|cpu]
  shs2sketch IN OUT [-z SIZE] [-b BITS] [--device cuda|cpu]
  stdin2ss [IN] [-S SIZE] [-a A] [-b B] [-H] [-o OUT] [--device cuda|cpu]
  setsketchroller KMERS... [-F paths] [-k K] [-o OUT] [-b]
          [--device cuda|cpu]
  genome2multiset GENOME [-k K] [-o PREFIX] [-C] [--device cuda|cpu]
  errexp [-l STEP] [--set-sizes LOG2S] [--sketch-sizes LOG2S]
         [--device cuda|cpu]
  ssi-build SKETCHES... -o OUT [-r REGS] [-k K] [--device cuda|cpu]
  ssi-screen INDEX QUERIES... [-n TOPN] [-r REGS] [--device cuda|cpu]
  hist DB [OUT] [--device cuda|cpu]
  lca nodes.dmp TAXIDS...
  taxmap NAMEIDMAP OUT
  fahist GENOMES... [-o OUT]
  kmeridx GENOME [-k K] -o OUT [--device cuda|cpu]
  metatree nodes.dmp NAMEIDMAP GENOMES... [-k K] [-F paths] [-L TAXID]...
           [-n NELEM] [-o OUT] [-C] [--device cuda|cpu]

``classify``, the ``--device-build`` builds, the shard owners of
``build --shards`` and the sketch front-ends run on ``--device`` (default
cuda, which must be present; cpu runs the kernels' plain torch
versions).  ``build`` takes spaced seeds (``-S``), entropy-file scores
(``-e``), uncanonical windows (``-C -w``) and the hash-scored phase 2
(``-t|-f --phase1-db P1``: minimizers ordered by the phase-1 map that
``prebuild -t|-f`` wrote), and writes a BTPU1 file, a sharded directory
(``--shards N``, or ``auto``: the fewest shards that keep each one's
slots within 128 MiB; it takes precedence) or the reference binary's
khash image (``--bonsai-format``); ``classify`` reads any of them, a
probe-image directory (``probe-image`` writes one from a BTPU1 or khash
database), of a contiguous or a spaced seed, and reads plain, .gz, .xz,
.bz2 and .zst FASTA/FASTQ.  ``-z`` gzips the database whatever its name,
as the reference does.  The
sketch front-ends (``kmercnt``, ``rolling-multk``, ``rolling-multk-sketch``,
``setsketch``, ``distmat``, ``cmpshs``) and sketch tools (``css2ss``,
``shs2sketch``, ``stdin2ss``, ``setsketchroller``, ``genome2multiset``,
``errexp``, ``ssi-build``/``setsketchindexer``,
``ssi-screen``/``setsketchscreener``) print and write what the JAX
package's do, but for two of its faults: its ``MultiKCounter`` counts the
windows of a long contig's chunk overlaps again for the smaller ks (here
each window counts once, ``sketch/shs.py``), and its ``distmat --hll``
merges its sketches in place, so that an entry (i, j) with j > i + 1
estimates the union of sketches i..j (here each pair's union comes from
the two sketches alone, ``HyperLogLog.union_estimate``).

``classify --trace-dir DIR`` runs the one-device classifier under
``torch.profiler`` (every thread of the pipeline, and on a card its
kernels and copies) and writes the trace to DIR as one
``*.pt.trace.json`` (PyTorch's TensorBoard layout, where the JAX CLI
writes ``jax.profiler``'s); with ``--db-shards`` it writes nothing, as
in the JAX CLI.  ``-v`` prints ``bonsai-tpu|`` and the version.

``classify --db-shards N`` runs the sharded classifier
(``parallel/sharded.py``) over N database ranks: on CUDA one rank a card
(N must divide the cards), on the CPU N ranks in this process; a sharded
directory with ``--db-shards`` loads a rank at a time
(``from_sharded_dir``), without it merges.  ``--distributed`` joins the
process group from torchrun's environment (one rank a process); a run of
several processes writes per-rank parts to ``-o DIR``, which
``merge-parts DIR`` joins into the one-process stream.  ``probe-image``
of a sharded directory bakes per-rank images for ``--db-ranks`` ranks.
The index and taxonomy tools print and write what the JAX package's
do: ``hist`` counts a database's values on ``--device``, ``kmeridx``
(``db/kmeridx.py``) encodes with KB1 and sorts on ``--device`` and writes
the JAX writer's bytes (gzipped), ``metatree`` (``metatree/``) builds
its k-mer sets with KB1 and its bit patterns on ``--device``; ``lca``,
``taxmap`` and ``fahist`` parse text on the host.
The option of ``bonsai_tpu`` that is not ported (k > 32 in the build)
exits 2 with the ROADMAP item that holds it; so does a database that is
neither BTPU1 nor a khash image (naming neither).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import List


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bonsai-tpu-torch")
    ap.add_argument("-v", "--version", action="store_true")
    sub = ap.add_subparsers(dest="cmd")

    p = sub.add_parser("classify", help="classify reads against a database")
    p.add_argument("db")
    p.add_argument("tax_path")
    p.add_argument("reads")
    p.add_argument("mate", nargs="?", default=None)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-c", "--chunk-size", type=int, default=4096)
    p.add_argument("-a", "--emit-all", action="store_true")
    p.add_argument("-k", "--kraken", dest="kraken", action="store_true",
                   default=True)
    p.add_argument("-K", "--no-kraken", dest="kraken", action="store_false")
    p.add_argument("-f", "--fastq", action="store_true")
    p.add_argument("-C", "--no-canon", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage wall times, and each span's wall "
                        "and CPU seconds and count (CPU below wall: off "
                        "the CPU, on the GIL or I/O), to stderr")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the run here")
    _device_arg(p)
    p.add_argument("--db-shards", type=int, default=0,
                   help="shard the table over N database ranks "
                        "(0 = the one-device classifier)")
    p.add_argument("--route", default="auto", choices=["auto", "a2a", "psum"],
                   help="sharded probe: a2a = all_to_all routed (default "
                        "where N > 1), psum = row ranges merged by a sum")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group from torchrun's "
                        "environment first (one rank a process)")

    p = sub.add_parser("build", aliases=["p2", "phase2"],
                       help="build the classify database")
    p.add_argument("out_path")
    p.add_argument("paths", nargs="*")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-w", type=int, default=-1)
    p.add_argument("-T", "--tax-path", required=True, help="nodes.dmp")
    p.add_argument("-M", "--seq2tax", required=True, help="name<TAB>taxid map")
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-C", "--no-canon", action="store_true")
    p.add_argument("-z", "--gzip", action="store_true",
                   help="write the database gzipped")
    p.add_argument("-S", "--spacing", default="",
                   help="spaced seed: k-1 gaps, e.g. 0x16,1x4")
    p.add_argument("-e", "--entropy", action="store_true",
                   help="entropy-file minimizer scores")
    p.add_argument("-t", "--tax-depth", action="store_true",
                   help="phase 2: minimizers by the phase-1 map's values")
    p.add_argument("-f", "--feature-count", action="store_true",
                   help="phase 2, as -t (the phase-1 map decides the order)")
    p.add_argument("--phase1-db", default=None,
                   help="the phase-1 map of -t/-f (prebuild -t|-f)")
    p.add_argument("--bonsai-format", action="store_true",
                   help="write the reference binary's khash image")
    p.add_argument("--shards", type=_shard_count, default=0, metavar="N|auto",
                   help="write OUT_PATH as a directory of N hash-prefix "
                        "shard files + manifest; auto: the fewest that "
                        "keep each shard's slots within 128 MiB")
    _device_args(p)

    p = sub.add_parser("prebuild", aliases=["p1", "phase1"],
                       help="build a phase-1 score map")
    p.add_argument("seq2tax")
    p.add_argument("tax_path")
    p.add_argument("out_path")
    p.add_argument("paths", nargs="*")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-C", "--no-canon", action="store_true")
    p.add_argument("-t", "--tax-depth", action="store_true")
    p.add_argument("-f", "--feature-count", action="store_true")
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-S", "--spacing", default="",
                   help="spaced seed: k-1 gaps, e.g. 0x16,1x4")
    _device_args(p)

    p = sub.add_parser("probe-image",
                       help="write a classify-ready probe image of a "
                            "database for a taxonomy")
    p.add_argument("db")
    p.add_argument("tax_path")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--db-ranks", type=int, default=0,
                   help="sharded directories: bake per-rank images for "
                        "this many db ranks (0 = one a shard file), "
                        "inside the directory")
    p.set_defaults(run=_cmd_probe_image)

    p = sub.add_parser("merge-parts",
                       help="join the per-rank parts of a multi-process "
                            "classify --distributed -o DIR into the "
                            "one-process stream")
    p.add_argument("parts_dir")
    p.add_argument("-o", "--out", default=None, help="default: stdout")
    p.set_defaults(run=_cmd_merge_parts)
    _sketch_parsers(sub)
    _index_parsers(sub)
    return ap


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (kernels, default) or cpu "
                        "(their plain torch versions)")


def _sketch_parsers(sub) -> None:
    p = sub.add_parser("kmercnt", help="multi-k kmer counting -> .shs/.bin "
                                       "dumps (bin/kmercnt.cpp)")
    p.add_argument("paths", nargs="+")
    p.add_argument("-k", "--ks", default="31", help="comma-separated k values")
    p.add_argument("-o", "--out-prefix", default=None,
                   help="default: input path")
    p.add_argument("-C", "--canon", action="store_true")
    p.add_argument("--shs-only", action="store_true")
    p.add_argument("--bin-only", action="store_true")
    p.add_argument("--nthash", action="store_true",
                   help="ntHash NTC64 backend (reference kmercnt -htype 2)")
    _device_arg(p)
    p.set_defaults(run=_cmd_kmercnt)

    p = sub.add_parser("setsketch", aliases=["setsketcher"],
                       help="per-file continuous SetSketch + union "
                            "(bin/setsketcher.cpp)")
    p.add_argument("paths", nargs="*")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-o", "--out", default="default.sketch")
    p.add_argument("-z", "--sketch-size", type=int, default=4096)
    p.add_argument("-C", "--no-canon", action="store_true")
    p.add_argument("-s", "--save-kmer-counts", action="store_true")
    p.add_argument("-S", "--save-kmers", action="store_true")
    p.add_argument("-Z", "--no-per-file", action="store_true")
    p.add_argument("-B", "--basename", action="store_true")
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-c", "--cyclic", action="store_true",
                   help="rolling cyclic hash instead of 2-bit kmers")
    p.add_argument("-P", "--protein", action="store_true",
                   help="protein k-mers (implies cyclic hashing, "
                        "setsketcher.cpp:125-128)")
    _device_arg(p)
    p.set_defaults(run=_cmd_setsketch)

    p = sub.add_parser("cmpshs",
                       help="pairwise compare .shs dumps (bin/cmpshs.cpp)")
    p.add_argument("paths", nargs="+")
    p.add_argument("-m", "--metric", default="jaccard",
                   choices=["jaccard", "intersection", "union", "containment"])
    p.add_argument("-o", "--out", default=None)
    _device_arg(p)
    p.set_defaults(run=_cmd_cmpshs)

    p = sub.add_parser("distmat",
                       help="genomes -> pairwise distance matrix (.tsv + "
                            ".npy), the run_dist.py + distmat2np.py "
                            "workflow (python/run_dist.py)")
    p.add_argument("paths", nargs="+")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-o", "--out", required=True,
                   help="output prefix (writes PREFIX.tsv, PREFIX.npy, "
                   "PREFIX.labels.txt)")
    p.add_argument("--metric", default="jaccard",
                   choices=["jaccard", "intersection", "union",
                            "containment", "mash"])
    p.add_argument("--hll", type=int, metavar="P", default=0,
                   help="estimate with HyperLogLog(p=P) sketches instead "
                   "of exact sets (run_dist's sketch mode)")
    p.add_argument("-C", "--no-canon", action="store_true")
    _device_arg(p)
    p.set_defaults(run=_cmd_distmat)

    p = sub.add_parser("rolling-multk", aliases=["rolling_multk"],
                       help="multi-k rolling-hash distinct counts "
                            "(bin/rolling_multk.cpp)")
    p.add_argument("paths", nargs="+")
    p.add_argument("-k", "--ks", default="17,21,25,29,31")
    p.add_argument("-C", "--canon", action="store_true")
    _device_arg(p)
    p.set_defaults(run=_cmd_rolling_multk)

    p = sub.add_parser("rolling-multk-sketch",
                       aliases=["rolling_multk_sketch"],
                       help="per-k CSetSketch over a rolling multi-k ladder "
                            "(bin/rolling_multk_sketch.cpp)")
    p.add_argument("paths", nargs="+")
    p.add_argument("-k", "--ks", default="17,21,25,29,31")
    p.add_argument("-z", "--sketch-size", type=int, default=1024)
    p.add_argument("-C", "--canon", action="store_true")
    p.add_argument("-o", "--out-prefix", default=None)
    _device_arg(p)
    p.set_defaults(run=_cmd_rolling_multk_sketch)
    _sketch_tool_parsers(sub)


def _sketch_tool_parsers(sub) -> None:
    """The sketch tools' parsers (bonsai_tpu/cli.py:190-281)."""
    p = sub.add_parser("css2ss",
                       help="continuous -> packed setsketch (bin/css2ss.cpp)")
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("-b", "--bits", type=int, default=16)
    _device_arg(p)
    p.set_defaults(run=_cmd_css2ss)

    p = sub.add_parser("shs2sketch", help="sorted-hash-set dump -> setsketch "
                                          "(bin/shs2sketch.cpp)")
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("-z", "--sketch-size", type=int, default=4096)
    p.add_argument("-b", "--bits", type=int, default=16)
    _device_arg(p)
    p.set_defaults(run=_cmd_shs2sketch)

    p = sub.add_parser("ssi-build", aliases=["setsketchindexer"],
                       help="build an LSH index over packed setsketches "
                            "(bin/setsketchindexer.cpp)")
    p.add_argument("sketches", nargs="+")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-r", "--regs-per-hash", type=int, default=4)
    p.add_argument("-k", type=int, default=0)
    _device_arg(p)
    p.set_defaults(run=_cmd_ssi_build)

    p = sub.add_parser("ssi-screen", aliases=["setsketchscreener"],
                       help="screen query sketches against an LSH index "
                            "(bin/setsketchscreener.cpp)")
    p.add_argument("index")
    p.add_argument("queries", nargs="+")
    p.add_argument("-n", "--topn", type=int, default=10)
    p.add_argument("-r", "--regs-per-hash", type=int, default=4)
    _device_arg(p)
    p.set_defaults(run=_cmd_ssi_screen)

    p = sub.add_parser("genome2multiset", help="genome -> kmer multiset .bin "
                                               "dump (bin/genome2multiset.cpp)")
    p.add_argument("path")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-o", "--out-prefix", default=None)
    p.add_argument("-C", "--canon", action="store_true")
    _device_arg(p)
    p.set_defaults(run=_cmd_genome2multiset)

    p = sub.add_parser("stdin2ss", help="raw u64 stream -> packed setsketch "
                                        "(bin/stdin2ss.cpp)")
    p.add_argument("inp", nargs="?", default=None, help="default: stdin")
    p.add_argument("-S", "--sketch-size", type=int, default=1000)
    p.add_argument("-a", type=float, default=-1.0)
    p.add_argument("-b", type=float, default=-1.0)
    p.add_argument("-H", "--use-short", action="store_true",
                   help="16-bit registers instead of 8-bit")
    p.add_argument("-o", "--out", default=None)
    _device_arg(p)
    p.set_defaults(run=_cmd_stdin2ss)

    p = sub.add_parser("setsketchroller",
                       help="build an inverted kmer->samples db from .kmers "
                            "dumps (bin/setsketchroller.cpp)")
    p.add_argument("kmer_files", nargs="*")
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-k", type=int, default=0)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-b", "--trim-folder", action="store_true")
    _device_arg(p)
    p.set_defaults(run=_cmd_setsketchroller)

    p = sub.add_parser("errexp",
                       help="sketch accuracy experiment: HLL vs CSetSketch "
                            "jaccard error (bin/errexp.cpp)")
    p.add_argument("-l", "--linspace", type=float, default=0.1)
    p.add_argument("--set-sizes", default="16,18,20")
    p.add_argument("--sketch-sizes", default="8,10,12")
    _device_arg(p)
    p.set_defaults(run=_cmd_errexp)


def _index_parsers(sub) -> None:
    p = sub.add_parser("hist",
                       help="taxid -> kmer-count histogram of a database")
    p.add_argument("db")
    p.add_argument("out", nargs="?", default=None)
    _device_arg(p)
    p.set_defaults(run=_cmd_hist)

    p = sub.add_parser("lca", help="LCA of taxids")
    p.add_argument("tax_path")
    p.add_argument("taxids", nargs="+", type=int)
    p.set_defaults(run=_cmd_lca)

    p = sub.add_parser("taxmap", help="build + save a name->taxid map")
    p.add_argument("nameidmap")
    p.add_argument("out")
    p.set_defaults(run=_cmd_taxmap)

    p = sub.add_parser("fahist",
                       help="sequence-length histogram (bin/fahist.cpp)")
    p.add_argument("paths", nargs="+")
    p.add_argument("-o", "--out", default=None)
    p.set_defaults(run=_cmd_fahist)

    p = sub.add_parser("kmeridx",
                       help="build a positional kmer index (bin/kmeridx.cpp)")
    p.add_argument("path")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-o", "--out", required=True)
    _device_arg(p)
    p.set_defaults(run=_cmd_kmeridx)

    p = sub.add_parser("metatree",
                       help="data-driven taxonomy restructuring "
                            "(bin/bonsai.cpp:410-518)")
    p.add_argument("tax_path", help="nodes.dmp")
    p.add_argument("nameidmap")
    p.add_argument("paths", nargs="*")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-L", "--accept-lca", type=int, action="append",
                   default=[])
    p.add_argument("-n", "--nelem", type=int, default=0,
                   help="nodes to emit (default roundup64(|tax|)-|tax|)")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-C", "--no-canon", action="store_true")
    _device_arg(p)
    p.set_defaults(run=_cmd_metatree)


def _device_args(p) -> None:
    p.add_argument("--device-build", action="store_true",
                   help="run the k-mer fold on the device "
                        "(db/build_device.py: kernels KB1-KB4)")
    _device_arg(p)


def _unported(args) -> str | None:
    """The message for a given option of bonsai_tpu that the port lacks."""
    if getattr(args, "k", 0) > 32:
        return ("not ported: a build of k > 32 (the JAX package's encoder "
                "takes k <= 32; core/encode128.py packs 128-bit k-mers but "
                "no build reaches it): ROADMAP queue A, item 8.6")
    return None


def _shard_count(value: str):
    """--shards: 0 (none), "auto" (None, decided from the k-mer count) or
    a count >= 1."""
    if value == "auto":
        return None
    n = int(value)
    if n < 0:
        raise argparse.ArgumentTypeError("a count >= 0 or auto")
    return n


def _paths(args) -> List[str]:
    if args.paths_file:
        with open(args.paths_file) as fh:
            return [line.strip() for line in fh if line.strip()]
    return list(args.paths)


def main(argv=None) -> int:
    ap = _parser()
    args, extra = ap.parse_known_args(argv)
    if args.version:
        from . import __version__

        print(f"bonsai-tpu|{__version__}")
        return 0
    if args.cmd is None:
        ap.print_help()
        return 1
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    build = args.cmd in ("build", "p2", "phase2")
    if not hasattr(args, "run"):
        msg = _unported(args)
        if msg is not None:
            print(msg, file=sys.stderr)
            return 2
    from .db.formats import NotADatabase

    try:
        if hasattr(args, "run"):  # probe-image, a tool
            return args.run(args)
        if args.cmd == "classify":
            return _cmd_classify(args)
        return _cmd_build(args) if build else _cmd_prebuild(args)
    except NotImplementedError as e:  # a discipline or an input
        print(f"not ported: {e}", file=sys.stderr)
        return 2
    except NotADatabase as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _cmd_classify(args) -> int:
    from .classify.pipeline import Classifier
    from .db import formats
    from .taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(args.tax_path)
    if args.distributed:
        from .parallel.mesh import init_distributed

        try:
            init_distributed(device=args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.db_shards:
        return _classify_sharded(args, tree)
    trace = contextlib.nullcontext()
    if args.trace_dir:
        trace = _trace(args.trace_dir, args.device)
        if trace is None:
            return 2
    emit = dict(emit_all=args.emit_all, emit_kraken=args.kraken,
                emit_fastq=args.fastq, device=args.device)
    if formats.is_probe_image(args.db):
        clf = Classifier.from_probe_image(args.db, tree, **emit)
    else:
        db = (formats.load_database_sharded(args.db)
              if formats.is_sharded_dir(args.db)
              else formats.load_database(args.db))
        clf = Classifier(db, tree, canonicalize=not args.no_canon, **emit)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        with trace:
            clf.process_dataset(args.reads, out, mate_path=args.mate,
                                batch_size=args.chunk_size,
                                profile=args.profile)
    finally:
        if args.out:
            out.close()
    print(f"classified: {clf.n_classified}  unclassified: {clf.n_unclassified}",
          file=sys.stderr)
    return 0


def _trace(trace_dir: str, device: str):
    """classify --trace-dir (``bonsai_tpu/cli.py`` :470-480, which wraps
    the run in ``jax.profiler.trace``): a ``torch.profiler`` run of every
    thread, the CPU's ranges and, on a card, its kernels and copies,
    written to ``trace_dir`` (made if missing) as one ``*.pt.trace.json``
    when it ends.  None, with the reason on stderr, where this torch
    cannot trace the threads the run starts: a trace of the main thread
    alone would lack the producer's and the writer's stages."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    try:
        threads = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError) as e:
        print(f"error: --trace-dir: torch {torch.__version__} cannot trace "
              f"every thread (_ExperimentalConfig(profile_all_threads=True): "
              f"{e})", file=sys.stderr)
        return None
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, experimental_config=threads,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def _classify_sharded(args, tree) -> int:
    """classify --db-shards N (``bonsai_tpu/cli.py`` :392-452): a sharded
    directory loads a rank at a time, any other database whole; a run of
    several processes writes per-rank parts to -o DIR."""
    from .db import formats
    from .parallel.mesh import default_mesh
    from .parallel.sharded import ShardedClassifier

    try:
        mesh = default_mesh(db_shards=args.db_shards, device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    emit = dict(canonicalize=not args.no_canon, emit_all=args.emit_all,
                emit_kraken=args.kraken, emit_fastq=args.fastq)
    if formats.is_probe_image(args.db):
        print("error: --db-shards takes a database or a sharded directory, "
              "not a probe image", file=sys.stderr)
        return 2
    if formats.is_sharded_dir(args.db):
        clf = ShardedClassifier.from_sharded_dir(args.db, tree, mesh, **emit)
    else:
        clf = ShardedClassifier(formats.load_database(args.db), tree, mesh,
                                route=args.route, **emit)
    if mesh.process_count > 1:
        if not args.out:
            print("--distributed multi-process classify needs -o DIR",
                  file=sys.stderr)
            return 2
        n = clf.process_dataset_distributed(args.reads, args.out,
                                            mate_path=args.mate,
                                            batch_size=args.chunk_size)
        pid = mesh.process_index
        print(f"[proc {pid}] wrote {n} rows to {args.out}/part-{pid:05d}.tsv "
              f"(classified: {clf.n_classified}  unclassified: "
              f"{clf.n_unclassified})", file=sys.stderr)
        return 0
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        clf.process_dataset(args.reads, out, mate_path=args.mate,
                            batch_size=args.chunk_size, profile=args.profile)
    finally:
        if args.out:
            out.close()
    print(f"classified: {clf.n_classified}  unclassified: {clf.n_unclassified}",
          file=sys.stderr)
    return 0


def _cmd_merge_parts(args) -> int:
    """The one-process stream of a multi-process classify's parts."""
    from .parallel.sharded import merge_distributed_output

    out = open(args.out, "w", encoding="utf-8") if args.out else sys.stdout
    try:
        n = merge_distributed_output(args.parts_dir, out)
    finally:
        if args.out:
            out.close()
    print(f"merged {n} bytes from {args.parts_dir}", file=sys.stderr)
    return 0


def _cmd_build(args) -> int:
    from .core.spacer import Spacer, parse_spacing
    from .db.formats import (Database, load_database, recommended_shards,
                             save_database, save_database_sharded,
                             write_bonsai_database)
    from .taxonomy.tree import TaxTree

    paths = _paths(args)
    if not paths:
        print("no input genomes", file=sys.stderr)
        return 1
    if args.shards != 0:  # the owners run on --device
        from .db.build_device import as_device

        as_device(args.device)
    k = args.k
    w = max(args.w, k)
    gaps = parse_spacing(args.spacing, k)
    sp = Spacer(k, w, gaps)
    tree = TaxTree.from_nodes_dmp(args.tax_path)
    canon = not args.no_canon
    if args.tax_depth or args.feature_count:
        # phase 2: the phase-1 map orders the minimizers (-e is ignored)
        if not args.phase1_db:
            print("-t/-f build requires --phase1-db", file=sys.stderr)
            return 1
        p1 = load_database(args.phase1_db).table
        scheme = "hash"
        if args.device_build:
            from .db.build_device import device_minimized_map

            table = device_minimized_map(paths, p1, tree, args.seq2tax, sp,
                                         canon, device=args.device)
        else:
            from .db.build import minimized_map

            table = minimized_map(paths, p1, tree, args.seq2tax, sp, canon)
    else:
        # `bonsai build -e` scores through the file overload's generic
        # windowed loops (core/entropy.py)
        scheme = "entropy-file" if args.entropy else "lex"
        if args.device_build:
            from .db.build_device import device_lca_map

            table = device_lca_map(paths, tree, args.seq2tax, sp, canon,
                                   scheme, device=args.device)
        else:
            from .db.build import lca_map

            table = lca_map(paths, tree, args.seq2tax, sp, canon, scheme)
    db = Database(table=table, k=k, w=w, gaps=gaps, canonicalize=canon,
                  scheme=scheme)
    compress = "gz" if args.gzip else None
    n_shards = args.shards
    if n_shards is None:
        n_shards = recommended_shards(table.n)
        print(f"--shards auto -> {n_shards}", file=sys.stderr)
    if n_shards:  # shards take precedence over --bonsai-format
        save_database_sharded(db, args.out_path, n_shards, compress,
                              device=args.device)
    elif args.bonsai_format:
        write_bonsai_database(db, args.out_path, compress=args.gzip)
    else:
        save_database(db, args.out_path, compress=compress)
    print(f"wrote {len(table)} kmers to {args.out_path}", file=sys.stderr)
    return 0


def _cmd_probe_image(args) -> int:
    """A classify-ready probe image of a BTPU1 or khash database, or the
    per-rank images of a sharded directory (``bonsai_tpu/cli.py``
    ``_cmd_probe_image``)."""
    from .db.formats import is_sharded_dir, load_database, save_probe_image
    from .taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(args.tax_path)
    if is_sharded_dir(args.db):
        from .parallel.sharded import bake_rank_images

        out = bake_rank_images(args.db, tree, args.db_ranks)
        print(f"baked per-rank images under {out}", file=sys.stderr)
        return 0
    if not args.out_dir:
        print("probe-image of a .btpu file needs OUT_DIR", file=sys.stderr)
        return 2
    db = load_database(args.db)
    save_probe_image(args.out_dir, db, tree)
    print(f"wrote probe image for {db.table.n} kmers to {args.out_dir}",
          file=sys.stderr)
    return 0


def _cmd_prebuild(args) -> int:
    from .core.spacer import Spacer, parse_spacing
    from .db.formats import Database, save_database
    from .taxonomy.tree import TaxTree

    k = args.k
    gaps = parse_spacing(args.spacing, k)
    sp = Spacer(k, k, gaps)
    tree = TaxTree.from_nodes_dmp(args.tax_path)
    paths = _paths(args)
    canon = not args.no_canon
    if args.device_build:
        from functools import partial

        from .db import build_device as bd

        build_ftct = partial(bd.device_ftct_map, device=args.device)
        build_td = partial(bd.device_taxdepth_map, device=args.device)
    else:
        from .db.build import ftct_map as build_ftct
        from .db.build import taxdepth_map as build_td
    if args.feature_count:
        table = build_ftct(paths, tree, args.seq2tax, sp, canon)
        scheme = "feature_count"
    else:
        table = build_td(paths, tree, args.seq2tax, sp, canon)
        scheme = "tax_depth"
    db = Database(table=table, k=k, w=k, gaps=gaps, canonicalize=canon,
                  scheme=scheme)
    save_database(db, args.out_path)
    print(f"wrote {len(table)} kmers to {args.out_path}", file=sys.stderr)
    return 0


# -- sketch front-ends (bonsai_tpu/cli.py:678-842,1128-1156) -------------------

def _cmd_kmercnt(args) -> int:
    from .sketch import shs as shs_mod

    ks = [int(x) for x in args.ks.split(",")]
    flag = 0
    if not args.bin_only:
        flag |= shs_mod.WRITE_SHS
    if not args.shs_only:
        flag |= shs_mod.WRITE_KVMAP
    for path in args.paths:
        prefix = args.out_prefix or path
        written = shs_mod.dump_maps(prefix, ks, path, canon=args.canon,
                                    flag=flag, nthash=args.nthash,
                                    device=args.device)
        print("\n".join(written), file=sys.stderr)
    return 0


def _cmd_setsketch(args) -> int:
    import os

    import torch

    from .core.alphabet import AMINO20, DNA4
    from .core.encoder import BatchEncoder
    from .core.spacer import Spacer
    from .db.build_device import as_device
    from .sketch.setsketch import CSetSketch
    from .sketch.shs import _contig_code_batches

    paths = list(args.paths)
    if args.paths_file:
        with open(args.paths_file) as fh:
            paths += [line.strip() for line in fh if line.strip()]
    if not paths:
        print("no input files", file=sys.stderr)
        return 1
    dev = as_device(args.device)
    k = args.k
    z = args.sketch_size
    canon = not args.no_canon
    cyclic = args.cyclic or args.protein or k > 32
    lut = AMINO20.lut if args.protein else DNA4.lut
    save_kmers = args.save_kmers or args.save_kmer_counts
    union = CSetSketch(z, save_kmers, args.save_kmer_counts, device=dev)
    if cyclic:
        from .core.rolling import RollingEncoder

        n_chars = AMINO20.n_classes if args.protein else 4
        renc = RollingEncoder(k, canon=canon and not args.protein,
                              n_chars=n_chars)
    else:
        enc = BatchEncoder(Spacer(k, k), canon)
    for path in paths:
        s = CSetSketch(z, save_kmers, args.save_kmer_counts, device=dev)
        for codes in _contig_code_batches(path, lut, overlap=k - 1):
            if codes.size < k:
                continue
            row = torch.from_numpy(codes[None, :]).to(dev)
            if cyclic:
                vals, invalid = renc.hashes(row)
                v = vals[0][~invalid[0]]
            else:
                em = enc.emissions(row, torch.tensor(
                    [codes.size], dtype=torch.int32, device=dev))
                v = em.values[0][em.mask[0]]
            s.update(v)
        card = s.cardinality()
        print(f"{path}\t{card:.1f}. Total updates {s.total_updates()}",
              file=sys.stderr)
        base = os.path.basename(path) if args.basename else path
        if not args.no_per_file:
            s.write(f"{base}.{k}.{z}.ss")
        if save_kmers:
            s.ids().tofile(f"{base}.{k}.{z}.u64.kmers")
            if args.save_kmer_counts:
                s.idcounts().tofile(f"{base}.{k}.{z}.u32.kmercounts")
        union.merge(s)
    print(f"union cardinality: {union.cardinality():.1f}", file=sys.stderr)
    union.write(args.out)
    return 0


def distance_matrix(sets, metric: str, k: int, hll: int, device):
    """The (n, n) matrix of ``distmat`` over sorted distinct k-mer sets:
    exact, or from HyperLogLog(p=hll) sketches, each pair's union estimated
    from the two sketches alone (union_estimate)."""
    import numpy as np

    from .core.bitops import as_keys
    from .sketch import compare
    from .sketch.hll import HyperLogLog

    n = len(sets)
    want_j = metric in ("jaccard", "mash")
    if hll:
        hlls = []
        for s in sets:
            h = HyperLogLog(hll, device)
            h.addh(s)
            hlls.append(h)
        card = np.array([h.report() for h in hlls])
        mat = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            mat[i, i] = 1.0 if want_j else card[i]
            for j in range(i + 1, n):
                u = hlls[i].union_estimate(hlls[j])
                inter = max(card[i] + card[j] - u, 0.0)
                v = {
                    "jaccard": inter / max(u, 1e-12),
                    "mash": inter / max(u, 1e-12),
                    "intersection": inter,
                    "union": u,
                    "containment": inter / max(card[i], 1e-12),
                }[metric]
                mat[i, j] = mat[j, i] = v
    else:
        mat = compare.pairwise_matrix([as_keys(s, device) for s in sets],
                                      metric="jaccard" if want_j else metric)
    if metric == "mash":
        with np.errstate(divide="ignore"):
            j = np.clip(mat, 1e-300, 1.0)
            mat = -np.log(2.0 * j / (1.0 + j)) / k
        np.fill_diagonal(mat, 0.0)
    return mat


def _cmd_distmat(args) -> int:
    """The reference's distance-matrix workflow (python/run_dist.py,
    distmat2np.py): PREFIX.tsv (labeled), PREFIX.npy and
    PREFIX.labels.txt.  --metric mash converts Jaccard j to
    -ln(2j/(1+j))/k; --hll P estimates from HyperLogLog sketches."""
    import os

    import numpy as np

    from .core.spacer import Spacer
    from .db.build import genome_kmer_set
    from .db.build_device import as_device

    dev = as_device(args.device)
    sp = Spacer(args.k, args.k)
    sets = [genome_kmer_set(p, sp, not args.no_canon) for p in args.paths]
    n = len(sets)
    mat = distance_matrix(sets, args.metric, args.k, args.hll, dev)
    labels = [os.path.basename(p) for p in args.paths]
    with open(args.out + ".tsv", "w") as fh:
        fh.write("#genome\t" + "\t".join(labels) + "\n")
        for i, lab in enumerate(labels):
            fh.write(lab + "\t" + "\t".join(f"{v:.8g}" for v in mat[i]) + "\n")
    np.save(args.out + ".npy", mat.astype(np.float32))
    with open(args.out + ".labels.txt", "w") as fh:
        fh.write("\n".join(labels) + "\n")
    print(f"wrote {n}x{n} {args.metric} matrix to {args.out}.npy/.tsv",
          file=sys.stderr)
    return 0


def _cmd_cmpshs(args) -> int:
    from .core.bitops import as_keys
    from .db.build_device import as_device
    from .sketch import compare, shs as shs_mod

    dev = as_device(args.device)
    sets = [as_keys(shs_mod.read_shs(p), dev) for p in args.paths]
    mat = compare.pairwise_matrix(sets, metric=args.metric)
    out = open(args.out, "w") if args.out else sys.stdout
    out.write("#path\t" + "\t".join(args.paths) + "\n")
    for i, p in enumerate(args.paths):
        out.write(p + "\t" + "\t".join(f"{v:.8g}" for v in mat[i]) + "\n")
    if args.out:
        out.close()
    return 0


def _cmd_rolling_multk(args) -> int:
    from .sketch.shs import MultiKCounter

    ks = [int(x) for x in args.ks.split(",")]
    for path in args.paths:
        ctr = MultiKCounter(ks, canon=args.canon, device=args.device)
        ctr.add_file(path)
        for k, s in zip(ks, ctr.key_sets()):
            print(f"{path}\tk={k}\t{s.numel()}")
    return 0


def _cmd_rolling_multk_sketch(args) -> int:
    """rolling_multk_sketch (bin/rolling_multk_sketch.cpp): one rolling
    pass per file, a CSetSketch per k."""
    from .sketch.setsketch import CSetSketch
    from .sketch.shs import MultiKCounter

    ks = [int(x) for x in args.ks.split(",")]
    for path in args.paths:
        ctr = MultiKCounter(ks, canon=args.canon, device=args.device)
        ctr.add_file(path)
        for k, hashes_sorted in zip(ks, ctr.key_sets()):
            cs = CSetSketch(args.sketch_size, device=args.device)
            cs.update(hashes_sorted)
            print(f"{path}\tk={k}\tcard~{cs.cardinality():.1f}")
            if args.out_prefix:
                cs.write(f"{args.out_prefix}.{k}.css")
    return 0


# -- sketch tools (bonsai_tpu/cli.py:844-1065) ---------------------------------

def _cmd_css2ss(args) -> int:
    from .db.build_device import as_device
    from .sketch.setsketch import CSetSketch

    cs = CSetSketch.read(args.inp, device=as_device(args.device))
    b, a = cs.optimal_parameters(qmax=(1 << args.bits) - 1)
    cs.to_packed(b, a, args.bits).write(args.out)
    print(f"packed {cs.m} registers (a={a:.6g} b={b:.6g})", file=sys.stderr)
    return 0


def _cmd_shs2sketch(args) -> int:
    from .db.build_device import as_device
    from .sketch.setsketch import CSetSketch
    from .sketch.shs import read_shs

    cs = CSetSketch(args.sketch_size, device=as_device(args.device))
    cs.update(read_shs(args.inp))
    b, a = cs.optimal_parameters(qmax=(1 << args.bits) - 1)
    cs.to_packed(b, a, args.bits).write(args.out)
    return 0


def _load_packed_sketches(paths, bits: int = 16, ab=None, device="cuda"):
    """Packed (.ss) sketches as they are, continuous ones packed with one
    global (a, b) over all of them, so that register values compare
    across samples (LSH grouping) -> (sketches, (b, a) or None)."""
    from .sketch.setsketch import CSetSketch, SetSketch

    loaded = []
    for p in paths:
        try:
            loaded.append(SetSketch.read(p))
        except ValueError:
            loaded.append(CSetSketch.read(p, device=device))
    cont = [s for s in loaded if isinstance(s, CSetSketch)]
    if not cont:
        return loaded, None
    if ab is not None:
        b, a = ab
    else:
        maxv = max(s.max() for s in cont)
        minv = min(s.min() for s in cont if s.min() > 0)
        b, a = cont[0].optimal_parameters(maxv, minv, (1 << bits) - 1)
    return [s.to_packed(b, a, bits) if isinstance(s, CSetSketch) else s
            for s in loaded], (b, a)


def _cmd_ssi_build(args) -> int:
    import json

    from .db.build_device import as_device
    from .sketch.ssi import SetSketchIndex

    sketches, packed = _load_packed_sketches(args.sketches,
                                            device=as_device(args.device))
    if packed:
        print(f"packed continuous inputs with global a={packed[1]:.6g} "
              f"b={packed[0]:.6g}", file=sys.stderr)
        with open(args.out + ".params", "w") as fh:
            json.dump({"b": packed[0], "a": packed[1], "bits": 16}, fh)
    idx = SetSketchIndex(k=args.k, regs_per_hash=args.regs_per_hash)
    for s in sketches:
        idx.add(s.registers)
    idx.write(args.out)
    print(f"indexed {idx.n_samples} sketches, {len(idx.map)} keys",
          file=sys.stderr)
    return 0


def _cmd_ssi_screen(args) -> int:
    import json
    import os

    from .db.build_device import as_device
    from .sketch.ssi import SetSketchIndex

    dev = as_device(args.device)
    idx = SetSketchIndex.read(args.index, regs_per_hash=args.regs_per_hash)
    ab = None
    if os.path.exists(args.index + ".params"):
        with open(args.index + ".params") as fh:
            d = json.load(fh)
        ab = (d["b"], d["a"])
    sketches, _ = _load_packed_sketches(args.queries, ab=ab, device=dev)
    for p, s in zip(args.queries, sketches):
        hits = idx.topk(s.registers, args.topn)
        row = "\t".join(f"{sid}:{c}" for sid, c in hits)
        print(f"{p}\t{row}")
    return 0


def _cmd_genome2multiset(args) -> int:
    from .db.build_device import as_device
    from .sketch import shs as shs_mod

    dev = as_device(args.device)
    written = shs_mod.dump_maps(args.out_prefix or args.path, [args.k],
                                args.path, canon=args.canon,
                                flag=shs_mod.WRITE_KVMAP, device=dev)
    print("\n".join(written), file=sys.stderr)
    return 0


def _cmd_stdin2ss(args) -> int:
    """stdin2ss (bin/stdin2ss.cpp): 16-byte records, the first u64 of each
    sketched into a b-bit packed SetSketch."""
    import numpy as np

    from .db.build_device import as_device
    from .sketch.setsketch import CSetSketch

    dev = as_device(args.device)
    if args.inp:
        with open(args.inp, "rb") as fh:
            raw = fh.read()
    else:
        raw = sys.stdin.buffer.read()
    vals = np.frombuffer(raw[: len(raw) // 16 * 16], dtype=np.uint64)[0::2]
    cs = CSetSketch(args.sketch_size, device=dev)
    cs.update(vals)
    bits = 16 if args.use_short else 8
    if args.a > 0 and args.b > 0:
        b, a = args.b, args.a
    else:
        b, a = cs.optimal_parameters(qmax=(1 << bits) - 1)
    cs.to_packed(b, a, bits).write(args.out or "/dev/stdout")
    print(f"processed {vals.size} total", file=sys.stderr)
    return 0


def _cmd_setsketchroller(args) -> int:
    """setsketchroller (bin/setsketchroller.cpp): an inverted kmer ->
    sample index over the .u64.kmers dumps of ``setsketch -S``; host
    work."""
    import os

    import numpy as np

    from .db.build_device import as_device
    from .sketch.ssi import SetSketchIndex

    as_device(args.device)
    paths = list(args.kmer_files)
    if args.paths_file:
        with open(args.paths_file) as fh:
            paths += [line.strip() for line in fh if line.strip()]
    if not paths:
        print("no input .kmers files", file=sys.stderr)
        return 1
    idx = SetSketchIndex(k=args.k)
    for sid, p in enumerate(paths):
        for km in np.unique(np.fromfile(p, dtype=np.uint64)):
            idx.map.setdefault(int(km), []).append(sid)
        idx.n_samples = sid + 1
    idx.write(args.out or "/dev/stdout")
    for sid, p in enumerate(paths):
        print(f"{sid}\t{os.path.basename(p) if args.trim_folder else p}",
              file=sys.stderr)
    return 0


def _cmd_errexp(args) -> int:
    """errexp (bin/errexp.cpp): the Jaccard estimates of HyperLogLog (KS1)
    and CSetSketch (KS2) against the truth, over set and sketch sizes."""
    import numpy as np

    from .db.build_device import as_device
    from .sketch.hll import HyperLogLog
    from .sketch.setsketch import CSetSketch

    dev = as_device(args.device)
    rng = np.random.default_rng(0)
    set_sizes = [1 << int(x) for x in args.set_sizes.split(",")]
    sketch_p = [int(x) for x in args.sketch_sizes.split(",")]
    jaccards = np.arange(args.linspace, 1.0, args.linspace)
    print("#setsize\tsketch\tm\ttrue_j\thll_j\tcss_j")
    for n in set_sizes:
        base = rng.integers(0, 1 << 62, 2 * n, dtype=np.uint64)
        for j in jaccards:
            # two sets of n with expected Jaccard j: s elements shared
            s = int(round(2 * j / (1 + j) * n))
            a = base[:n]
            b = np.concatenate([base[:s], base[n:2 * n - s]])
            for p in sketch_p:
                h1, h2 = HyperLogLog(p, dev), HyperLogLog(p, dev)
                h1.addh(a)
                h2.addh(b)
                c1, c2 = CSetSketch(1 << p, device=dev), CSetSketch(
                    1 << p, device=dev)
                c1.update(a)
                c2.update(b)
                print(f"{n}\thll/css\t{1 << p}\t{j:.3f}\t"
                      f"{h1.jaccard(h2):.4f}\t{c1.jaccard(c2):.4f}")
    return 0


# -- index and taxonomy tools (bonsai_tpu/cli.py:629-675,950-974,1066-1125) ---

def _cmd_hist(args) -> int:
    """Histogram of k-mers per taxid (bin/bonsai.cpp:351-374): the
    distinct values counted on the device, in a stable order of their
    counts."""
    import os

    import numpy as np
    import torch

    from .core.bitops import SIGN
    from .db.build_device import as_device
    from .db.formats import (import_bonsai_database, load_database,
                             load_database_sharded)

    dev = as_device(args.device)
    if os.path.isdir(args.db):
        db = load_database_sharded(args.db)
    else:
        try:
            db = load_database(args.db)
        except ValueError:
            db = import_bonsai_database(args.db)
    vals = np.ascontiguousarray(db.table.vals_sorted)
    flip = SIGN if vals.dtype == np.uint64 else 0  # unsigned order
    v = torch.from_numpy(vals.astype(np.uint64).view(np.int64)).to(dev) ^ flip
    uniq, counts = torch.unique(v, sorted=True, return_counts=True)
    _, order = torch.sort(counts, stable=True)
    uniq = ((uniq[order] ^ flip).cpu().numpy().view(np.uint64)
            .astype(vals.dtype))
    counts = counts[order].cpu().numpy()
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        out.write("Name\tCount\n")
        out.write("".join(f"{v}\t{c}\n" for v, c in zip(uniq, counts)))
    finally:
        if args.out:
            out.close()
    return 0


def _cmd_lca(args) -> int:
    from .taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(args.tax_path)
    acc = args.taxids[0]
    for t in args.taxids[1:]:
        acc = tree.lca(acc, t)
    print(acc)
    return 0


def _cmd_taxmap(args) -> int:
    import json

    from .taxonomy.ncbi import parse_nameid_map

    nm = parse_nameid_map(args.nameidmap)
    with open(args.out, "w") as fh:
        json.dump(nm, fh)
    print(f"wrote {len(nm)} names", file=sys.stderr)
    return 0


def _cmd_fahist(args) -> int:
    """fahist (bin/fahist.cpp): each file's sequence lengths and their
    counts; host work."""
    from collections import Counter

    from .io import fastx

    out = open(args.out, "w") if args.out else sys.stdout
    try:
        for path in args.paths:
            hist = Counter(len(seq) for _, seq, _ in fastx.read_fastx(path))
            out.write(f"#{path}\n")
            for length in sorted(hist):
                out.write(f"{length}\t{hist[length]}\n")
    finally:
        if args.out:
            out.close()
    return 0


def _cmd_kmeridx(args) -> int:
    from .db.kmeridx import KmerIdx

    idx = KmerIdx(args.k, args.path, device=args.device)
    idx.write(args.out)
    print(f"indexed {len(idx)} distinct {args.k}-mers", file=sys.stderr)
    return 0


def _cmd_metatree(args) -> int:
    """metatree_main (bin/bonsai.cpp:410-518): group the genomes' taxa by
    parent, score the shared k-mer bit patterns of each group on the
    device, emit the best candidate new taxonomy nodes."""
    from .core.spacer import Spacer
    from .db.build_device import as_device
    from .metatree.flextree import FMEmitter
    from .metatree.tx import _taxid_of_path
    from .taxonomy.ncbi import parse_nameid_map
    from .taxonomy.tree import TaxTree

    dev = as_device(args.device)
    tree = TaxTree.from_nodes_dmp(args.tax_path)
    name_map = parse_nameid_map(args.nameidmap)
    sp = Spacer(args.k, args.k)

    # filter genomes by accepted LCAs (accepted_pass, bin/bonsai.cpp:404)
    tax_to_paths = {}
    for p in _paths(args):
        tid = _taxid_of_path(p, name_map)
        if tid is None:
            continue
        if args.accept_lca and not any(
            tree.lca(lca, tid) == lca for lca in args.accept_lca
        ):
            continue
        tax_to_paths.setdefault(tid, []).append(p)
    if not tax_to_paths:
        print("no genomes mapped to taxa", file=sys.stderr)
        return 1

    # tax2desc map: each taxon also sees its descendants' genomes
    # (tax2desc_genome_map, util.h:1023)
    desc_map = {t: list(ps) for t, ps in tax_to_paths.items()}
    for t, ps in tax_to_paths.items():
        tid = t
        while True:
            parent = tree.parent_map.get(tid, 0)
            if parent == 0:
                break
            desc_map.setdefault(parent, []).extend(ps)
            tid = parent

    fme = FMEmitter(tree, desc_map, canonicalize=not args.no_canon,
                    to_add=args.nelem, device=dev)
    # group leaf taxa by parent, one subtree per parent group
    groups = {}
    for t in tax_to_paths:
        groups.setdefault(tree.parent_map.get(t, 0), []).append(t)
    for parent, taxes in sorted(groups.items()):
        fme.process_subtree(parent, sorted(taxes), sp)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        emitted = fme.run_collapse(max(tree.parent_map), out)
    finally:
        if args.out:
            out.close()
    print(f"emitted {len(emitted)} candidate nodes", file=sys.stderr)
    return 0
