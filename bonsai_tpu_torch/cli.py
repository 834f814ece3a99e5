"""Command line of the PyTorch/CUDA port: ``build``, ``prebuild`` and
``classify``.

Flags follow ``bonsai_tpu/cli.py`` (and the reference ``bonsai``
subcommands, bin/bonsai.cpp) for the ported slice:

  build OUT GENOMES... -k K [-w W] [-S SPACING] [-e] -T nodes.dmp
        -M nameidmap [-C] [-z] [-F paths] [-t|-f --phase1-db P1]
        [--device-build] [--device cuda|cpu]
  prebuild NAMEIDMAP nodes.dmp OUT GENOMES... -k K [-S SPACING] [-C]
        [-t|-f] [-F paths] [--device-build] [--device cuda|cpu]
  classify DB nodes.dmp READS [MATE] [-a] [-f] [-k|-K] [-C] [-o OUT]
           [-c CHUNK] [--profile] [--device cuda|cpu]

``classify`` and the ``--device-build`` builds run on ``--device``
(default cuda, which must be present; cpu runs the kernels' plain torch
versions).  ``build`` takes spaced seeds (``-S``), entropy-file scores
(``-e``), uncanonical windows (``-C -w``) and the hash-scored phase 2
(``-t|-f --phase1-db P1``: minimizers ordered by the phase-1 map that
``prebuild -t|-f`` wrote); ``classify`` reads a BTPU1
database file or a probe-image directory, of a contiguous or a spaced
seed, and reads plain, .gz, .xz, .bz2 and .zst FASTA/FASTQ.  ``-z``
gzips the BTPU1 file whatever its name, as the reference does.  Options
of ``bonsai_tpu`` that are not ported (other file formats, sharded
output, k > 32) and inputs that the port refuses (a database or phase-1
map that is not BTPU1) exit 2 with the ROADMAP item that holds them.
"""

from __future__ import annotations

import argparse
import sys
from typing import List


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bonsai-tpu-torch")
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
                   help="print per-stage wall times to stderr")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (kernels, default) or cpu "
                        "(their plain torch versions)")

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
    _device_args(p)
    # not ported: each exits non-zero (_unported)
    p.add_argument("--bonsai-format", action="store_true")
    p.add_argument("--shards", default="0")

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
    return ap


def _device_args(p) -> None:
    p.add_argument("--device-build", action="store_true",
                   help="run the k-mer fold on the device "
                        "(db/build_device.py: kernels KB1-KB4)")
    p.add_argument("--device", default="cuda",
                   help="device of --device-build: cuda (kernels, default) "
                        "or cpu (their plain torch versions)")


_UNPORTED = {
    "bonsai_format": "the reference khash format (--bonsai-format): ROADMAP "
                     "queue A, item 10",
    "shards": "sharded database directories (--shards): ROADMAP queue A, "
              "item 10",
}


def _unported(args, names) -> str | None:
    """The message for a given option of bonsai_tpu that the port lacks."""
    for name in names:
        if getattr(args, name) not in ("", "0", False, None):
            return f"not ported: {_UNPORTED[name]}"
    if args.k > 32:
        return "not ported: 128-bit k-mers (k > 32): ROADMAP queue A, item 8.6"
    return None


def _paths(args) -> List[str]:
    if args.paths_file:
        with open(args.paths_file) as fh:
            return [line.strip() for line in fh if line.strip()]
    return list(args.paths)


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 1
    build = args.cmd in ("build", "p2", "phase2")
    if args.cmd != "classify":
        msg = _unported(args, _UNPORTED if build else ())
        if msg is not None:
            print(msg, file=sys.stderr)
            return 2
    try:
        if args.cmd == "classify":
            return _cmd_classify(args)
        return _cmd_build(args) if build else _cmd_prebuild(args)
    except NotImplementedError as e:  # a discipline, database or input
        # (load_database names item 10 for a file that is not BTPU1)
        print(f"not ported: {e}", file=sys.stderr)
        return 2


def _cmd_classify(args) -> int:
    from .classify.pipeline import Classifier
    from .db import formats
    from .taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(args.tax_path)
    emit = dict(emit_all=args.emit_all, emit_kraken=args.kraken,
                emit_fastq=args.fastq, device=args.device)
    if formats.is_probe_image(args.db):
        clf = Classifier.from_probe_image(args.db, tree, **emit)
    else:
        clf = Classifier(formats.load_database(args.db), tree,
                         canonicalize=not args.no_canon, **emit)
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


def _cmd_build(args) -> int:
    from .core.spacer import Spacer, parse_spacing
    from .db.formats import Database, load_database, save_database
    from .taxonomy.tree import TaxTree

    paths = _paths(args)
    if not paths:
        print("no input genomes", file=sys.stderr)
        return 1
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
    save_database(db, args.out_path, compress="gz" if args.gzip else None)
    print(f"wrote {len(table)} kmers to {args.out_path}", file=sys.stderr)
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
