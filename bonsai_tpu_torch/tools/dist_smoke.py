"""Multi-process check of the sharded classifier under torch.distributed.

Starts NPROC processes (2 by default, or 4) joined by ``gloo`` on the
CPU, as torchrun would (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  Each
runs ``classify --db-shards 2 --distributed -o DIR --device cpu`` of a
small database (both routes, and the a2a route from a ``build --shards
2`` directory), writing its rank's part, the sequence-parallel encode
of a contig (``ppermute`` between processes) and the sharded fold
(``sharded_lca_map``, one key range a process), each against the
unsharded function, and checks that a mesh of more ranks than
processes is refused; then ``merge-parts`` joins each
run's parts, and the merged text must equal the one-process
``classify`` of the same reads.  Prints "dist_smoke: OK" when all agree.

    python -m bonsai_tpu_torch.tools.dist_smoke [--nproc 2|4]

(worker mode, used by the launcher: ``--worker DIR``).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RUNS = (("a2a", "db.btpu"), ("psum", "db.btpu"), ("a2a", "sh2"))
K = 17


def _problem(d: str) -> None:
    """Under ``d``: four random 3000-base genomes of four taxa, their k = 17
    database (``build``) and its 2-shard directory (``build --shards
    2``), 400 random reads and 200 reads cut from the genomes, and the
    taxonomy."""
    import numpy as np

    from bonsai_tpu_torch import cli

    rng = np.random.default_rng(42)
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    with open(os.path.join(d, "reads.fa"), "w") as fh:
        for i in range(400):
            n = int(rng.integers(40, 160))
            fh.write(f">q{i}\n{bases[rng.integers(0, 4, n)].tobytes().decode()}\n")
    with open(os.path.join(d, "nodes.dmp"), "w") as fh:
        for c, p in ((1, 1), (2, 1), (11, 2), (12, 2), (13, 2)):
            fh.write(f"{c}\t|\t{p}\t|\n")
    genomes = []
    for i, taxid in enumerate((11, 12, 13, 2)):
        g = os.path.join(d, f"g{i}.fa")
        seq = bases[rng.integers(0, 4, 3000)].tobytes().decode()
        with open(g, "w") as fh:
            fh.write(f">G{i}\n{seq}\n")
        genomes.append((g, f"G{i}", taxid))
    with open(os.path.join(d, "reads.fa"), "a") as fh:  # reads with hits
        for i in range(200):
            g = genomes[i % 4][0]
            seq = open(g).read().split("\n")[1]
            s = int(rng.integers(0, len(seq) - 120))
            fh.write(f">h{i}\n{seq[s:s + 120]}\n")
    with open(os.path.join(d, "nameidmap.txt"), "w") as fh:
        for _, name, taxid in genomes:
            fh.write(f"{name}\t{taxid}\n")
    for out, extra in (("db.btpu", []), ("sh2", ["--shards", "2"])):
        rc = cli.main(["build", os.path.join(d, out),
                       *(g for g, _, _ in genomes), "-k", str(K), "-T",
                       os.path.join(d, "nodes.dmp"), "-M",
                       os.path.join(d, "nameidmap.txt"), *extra,
                       "--device", "cpu"])
        if rc:
            raise SystemExit(f"dist_smoke: build {out} failed ({rc})")


def worker(d: str) -> int:
    from bonsai_tpu_torch import cli

    rank = int(os.environ["RANK"])
    for route, db in RUNS:
        out = os.path.join(d, f"parts-{route}-{db}")
        rc = cli.main(["classify", os.path.join(d, db),
                       os.path.join(d, "nodes.dmp"),
                       os.path.join(d, "reads.fa"), "-a", "--db-shards", "2",
                       "--route", route, "--distributed", "-o", out,
                       "--device", "cpu", "-c", "256"])
        if rc:
            print(f"[rank {rank}] classify {route} {db} failed ({rc})")
            return rc
    import numpy as np
    import torch

    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.core.encoder import minimizers
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.db import build, build_device
    from bonsai_tpu_torch.io import fastx
    from bonsai_tpu_torch.parallel.mesh import make_mesh
    from bonsai_tpu_torch.parallel.sharded import sharded_encode_contig
    from bonsai_tpu_torch.taxonomy.tree import TaxTree

    world = int(os.environ["WORLD_SIZE"])
    # the sequence-parallel encode (ppermute between processes): this
    # rank's block equals that block of the unsharded encode
    seq = open(os.path.join(d, "g0.fa")).read().split("\n")[1][:2000]
    codes = torch.from_numpy(fastx.encode_contig(seq.encode(), DNA4.lut)
                             [None, :])
    kms, ok = sharded_encode_contig(codes, K,
                                    make_mesh({"sp": world}, ["cpu"]))
    em = minimizers(codes, torch.tensor([2000], dtype=torch.int32), K, 1,
                    True, zero_invalid=True)
    blk = 2000 // world
    want_k = torch.cat([em.values, torch.zeros((1, K - 1), dtype=torch.int64)],
                       1)[:, rank * blk:(rank + 1) * blk]
    want_ok = torch.cat([em.mask, torch.zeros((1, K - 1), dtype=torch.bool)],
                        1)[:, rank * blk:(rank + 1) * blk]
    if not (torch.equal(kms, want_k) and torch.equal(ok, want_ok)):
        print(f"[rank {rank}] sequence-parallel encode differs")
        return 1
    # the sharded fold, one key range a process, gathered by finish
    genomes = [os.path.join(d, f"g{i}.fa") for i in range(4)]
    tree = TaxTree.from_nodes_dmp(os.path.join(d, "nodes.dmp"))
    names = os.path.join(d, "nameidmap.txt")
    got = build_device.sharded_lca_map(genomes, tree, names, Spacer(K, K),
                                       make_mesh({"db": world}, ["cpu"]),
                                       block=1024)
    want = build.lca_map(genomes, tree, names, Spacer(K, K))
    if not (np.array_equal(got.keys_sorted, want.keys_sorted)
            and np.array_equal(got.vals_sorted, want.vals_sorted)):
        print(f"[rank {rank}] sharded_lca_map differs from lca_map")
        return 1
    print(f"[rank {rank}] sp encode and sharded fold equal the unsharded")
    try:  # in-process ranks beside processes: refused
        make_mesh({"dp": 1, "db": 2 * int(os.environ["WORLD_SIZE"])})
    except ValueError as e:
        print(f"[rank {rank}] refused: {e}")
    else:
        print(f"[rank {rank}] a mesh mixing ranks and processes was made")
        return 1
    print(f"[rank {rank}] ok", flush=True)
    return 0


def launch(nproc: int, timeout: float = 300.0) -> int:
    with tempfile.TemporaryDirectory(prefix="dist_smoke.") as d:
        return _run(d, nproc, timeout)


def _run(d: str, nproc: int, timeout: float) -> int:
    from bonsai_tpu_torch import cli

    _problem(d)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(nproc):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(nproc), RANK=str(r), LOCAL_RANK=str(r),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bonsai_tpu_torch.tools.dist_smoke",
             "--worker", d], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=ROOT, env=env))
    rc = 0
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            tail = "\n".join(out.splitlines()[-8:])
            print(f"--- rank {r} (rc={p.returncode}) ---\n{tail}")
            rc |= p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc == 0:
        ref = os.path.join(d, "single.tsv")
        rc |= cli.main(["classify", os.path.join(d, "db.btpu"),
                        os.path.join(d, "nodes.dmp"),
                        os.path.join(d, "reads.fa"), "-a", "-o", ref,
                        "--device", "cpu", "-c", "256"])
        want = open(ref, "rb").read()
        for route, db in RUNS:
            merged = os.path.join(d, f"merged-{route}-{db}.tsv")
            rc |= cli.main(["merge-parts", os.path.join(
                d, f"parts-{route}-{db}"), "-o", merged])
            parts = sorted(f for f in os.listdir(os.path.join(
                d, f"parts-{route}-{db}")) if f.endswith(".tsv"))
            same = open(merged, "rb").read() == want
            print(f"{route} {db}: {len(parts)} parts, merged text "
                  f"{'equals' if same else 'DIFFERS from'} the one-process "
                  f"text ({len(want)} bytes)")
            rc |= 0 if same else 1
    print("dist_smoke:", "OK" if rc == 0 else "FAILED")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dist_smoke")
    ap.add_argument("--nproc", type=int, default=2, choices=[2, 4])
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.worker:
        return worker(args.worker)
    return launch(args.nproc)


if __name__ == "__main__":
    sys.exit(main())
