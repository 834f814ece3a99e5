"""Deployments: what a configuration file names, made ready to run.

A configuration (``configs/<name>.json``) is one database deployment: the
genome, ``nodes.dmp`` and name-to-taxid files of the checkout it is built
from, each pinned by its sha256 so that a changed file fails the run
instead of changing the yardstick, and its seed (k, canonical k-mers).

A genome is a list of records, each a uint8 array of ASCII bases.  The
deployment is the data only: the program's build and the plain reference
each work their own database out of it.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class Genome:
    name: str  # the accession: the first header's first word
    taxid: int
    records: List[np.ndarray]  # uint8 ASCII bases, one array a record


@dataclass
class Deployment:
    name: str
    k: int
    canonical: bool
    genomes: List[Genome]  # the database's genomes, in build order
    parent: Dict[int, int]  # taxid -> parent taxid; the root 1 -> 0
    config: dict
    # the files the program's build reads
    genome_paths: List[str]
    nodes_path: str
    nameidmap_path: str


def config_digest(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()[:16]


def load(config_path: str, root: str) -> Deployment:
    """The deployment of ``config_path``; its files' paths are relative
    to the checkout ``root``."""
    with open(config_path) as fh:
        cfg = json.load(fh)
    if (cfg.get("spacing") or cfg.get("w", cfg["k"]) != cfg["k"]
            or cfg.get("scheme", "lex") != "lex"):
        raise ValueError(f"{cfg['name']}: only unspaced lex seeds with w = k "
                         "are read yet")
    paths = [pinned(root, g) for g in cfg["genomes"]]
    nodes = pinned(root, cfg["nodes_dmp"])
    names = pinned(root, cfg["nameidmap"])
    name_map = read_nameidmap(names)
    genomes = []
    for p in paths:
        recs = read_fasta(p)
        acc = recs[0][0]
        if acc not in name_map:
            raise ValueError(f"{p}: accession {acc} is not in {names}")
        genomes.append(Genome(acc, name_map[acc], [r for _, r in recs]))
    return Deployment(cfg["name"], int(cfg["k"]), bool(cfg["canonical"]),
                      genomes, read_nodes(nodes), cfg, paths, nodes, names)


def pinned(root: str, entry: dict) -> str:
    path = os.path.join(root, entry["path"])
    with open(path, "rb") as fh:
        got = hashlib.sha256(fh.read()).hexdigest()
    if got != entry["sha256"]:
        raise ValueError(f"{entry['path']}: sha256 {got}, pinned at "
                         f"{entry['sha256']}")
    return path


def read_fasta(path: str):
    """[(name, uint8 ASCII bases)] of a plain or gzip FASTA file."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return read_fasta_bytes(data)


def read_fasta_bytes(data: bytes):
    out = []
    for rec in data.split(b"\n>"):
        head, _, body = rec.partition(b"\n")
        name = head.lstrip(b">").split()[0].decode()
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        out.append((name, np.frombuffer(seq, dtype=np.uint8)))
    return out


def read_nodes(path: str) -> Dict[int, int]:
    """taxid -> parent of an NCBI ``nodes.dmp``; the root 1 -> 0."""
    parent = {}
    with open(path) as fh:
        for line in fh:
            cols = [c.strip() for c in line.split("|")]
            if len(cols) >= 2 and cols[0].isdigit():
                parent[int(cols[0])] = int(cols[1])
    parent[1] = 0
    return parent


def read_nameidmap(path: str) -> Dict[str, int]:
    out = {}
    with open(path) as fh:
        for line in fh:
            name, _, taxid = line.rstrip("\n").partition("\t")
            if name:
                out[name] = int(taxid)
    return out
