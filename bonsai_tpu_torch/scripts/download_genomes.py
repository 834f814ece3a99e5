"""RefSeq genome fetcher: the ref/ layout that the database build reads.

The port's own copy of ``bonsai_tpu/scripts/download_genomes.py`` (the
reference's python/download_genomes.py, with _subdir.py and
old_refseq.py): parse each clade's assembly_summary.txt, select the
complete (and, on request, reference or representative) genomes,
download their *_genomic.fna.gz files with a thread pool, check each
gzip stream whole, and write a nameidmap.txt (accession -> taxid) for
``build -M``, and the taxdump on request.  All of it is host work; only
the downloads need the network.  A clade whose summary and genomes are
already on disk and whole is not fetched again:

    python -m bonsai_tpu_torch.scripts.download_genomes --clades viral \
        -o ref [-p THREADS] [--all-levels] [--representative-only] \
        [--taxdump]
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, NamedTuple

DEFAULT_CLADES = [
    "archaea", "bacteria", "fungi", "viral", "protozoa",
]
REFSEQ_BASE = "https://ftp.ncbi.nlm.nih.gov/genomes/refseq"
TAXDUMP_URL = "https://ftp.ncbi.nih.gov/pub/taxonomy/taxdump.tar.gz"


class Assembly(NamedTuple):
    accession: str
    taxid: int
    species_taxid: int
    level: str  # assembly_level
    category: str  # refseq_category
    ftp_path: str

    @property
    def fna_url(self) -> str:
        base = self.ftp_path.rstrip("/")
        name = base.rsplit("/", 1)[-1]
        return f"{base}/{name}_genomic.fna.gz"


def summary_url(clade: str) -> str:
    return f"{REFSEQ_BASE}/{clade}/assembly_summary.txt"


def parse_assembly_summary(fh: Iterable[str]) -> List[Assembly]:
    """Parse NCBI assembly_summary.txt (tab-separated, '#' comments)."""
    out = []
    for line in fh:
        if line.startswith("#") or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 20 or not f[19] or f[19] == "na":
            continue
        try:
            taxid = int(f[5])
            sp_taxid = int(f[6])
        except ValueError:
            continue
        out.append(
            Assembly(
                accession=f[0],
                taxid=taxid,
                species_taxid=sp_taxid,
                level=f[11],
                category=f[4],
                ftp_path=f[19].replace("ftp://", "https://"),
            )
        )
    return out


def select_assemblies(
    assemblies: List[Assembly],
    complete_only: bool = True,
    representative_only: bool = False,
) -> List[Assembly]:
    sel = assemblies
    if complete_only:
        sel = [a for a in sel if a.level == "Complete Genome"]
    if representative_only:
        sel = [
            a
            for a in sel
            if a.category in ("reference genome", "representative genome")
        ]
    return sel


def is_valid_gzip(path: str) -> bool:
    """Full-stream integrity check (the reference shells out to gzip -t)."""
    try:
        with gzip.open(path, "rb") as fh:
            while fh.read(1 << 20):
                pass
        return True
    except (OSError, EOFError):
        return False


def _fetch(url: str, dest: str, retries: int = 3) -> bool:
    for _ in range(retries):
        try:
            urllib.request.urlretrieve(url, dest)
            if dest.endswith(".gz") and not is_valid_gzip(dest):
                os.unlink(dest)
                continue
            return True
        except OSError:
            continue
    return False


def write_nameidmap(assemblies: List[Assembly], path: str):
    """accession -> taxid map consumed by `build -M` (two-column TSV)."""
    with open(path, "w") as fh:
        for a in assemblies:
            fh.write(f"{a.accession}\t{a.taxid}\n")


def download_clade(
    clade: str,
    out_dir: str,
    threads: int = 8,
    complete_only: bool = True,
    representative_only: bool = False,
) -> List[str]:
    """Download one clade into out_dir/<clade>/; resumable (existing valid
    files are skipped).  Returns local paths."""
    clade_dir = os.path.join(out_dir, clade)
    os.makedirs(clade_dir, exist_ok=True)
    summary_path = os.path.join(clade_dir, "assembly_summary.txt")
    if not os.path.exists(summary_path):
        if not _fetch(summary_url(clade), summary_path):
            raise RuntimeError(f"cannot fetch {summary_url(clade)}")
    with open(summary_path) as fh:
        assemblies = select_assemblies(
            parse_assembly_summary(fh), complete_only, representative_only
        )
    write_nameidmap(assemblies, os.path.join(clade_dir, "nameidmap.txt"))
    jobs = []
    paths = []
    for a in assemblies:
        dest = os.path.join(clade_dir, a.fna_url.rsplit("/", 1)[-1])
        paths.append(dest)
        if not (os.path.exists(dest) and is_valid_gzip(dest)):
            jobs.append((a.fna_url, dest))
    with ThreadPoolExecutor(max_workers=threads) as ex:
        results = list(ex.map(lambda j: _fetch(*j), jobs))
    failed = [j[0] for j, ok in zip(jobs, results) if not ok]
    for url in failed:
        print(f"FAILED: {url}", file=sys.stderr)
    return [p for p in paths if os.path.exists(p)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--clades", nargs="+", default=DEFAULT_CLADES)
    ap.add_argument("-o", "--out-dir", default="ref")
    ap.add_argument("-p", "--threads", type=int, default=8)
    ap.add_argument("--all-levels", action="store_true",
                    help="include non-complete assemblies")
    ap.add_argument("--representative-only", action="store_true")
    ap.add_argument("--taxdump", action="store_true",
                    help="also fetch taxdump.tar.gz")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.taxdump:
        _fetch(TAXDUMP_URL, os.path.join(args.out_dir, "taxdump.tar.gz"))
    for clade in args.clades:
        got = download_clade(
            clade, args.out_dir, args.threads,
            complete_only=not args.all_levels,
            representative_only=args.representative_only,
        )
        print(f"{clade}: {len(got)} genomes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
