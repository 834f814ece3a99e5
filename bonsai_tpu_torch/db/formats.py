"""Database files: BTPU1 and the classify-ready probe image.

Counterpart of ``bonsai_tpu/db/formats.py`` (``save_database``,
``load_database``, ``save_probe_image``, ``load_probe_image``), byte for
byte: a file written by either package loads in the other.

* BTPU1: magic + JSON header + raw little-endian sorted key and value
  arrays; the probe table is rebuilt by placement on load.
* probe image: a directory of ``slots.npy`` + ``vals.npy`` (the slot
  image already packed with the classifier's payload, memory-mapped on
  load) + ``meta.json``.

Sharded directories and the reference khash image are not ported yet
(ROADMAP queue A, item 10).
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .table import KmerTable, unique_u64

MAGIC = b"BTPU1\n"


@dataclass
class Database:
    """A loaded database: table + seed geometry."""

    table: KmerTable
    k: int
    w: int
    gaps: List[int]
    canonicalize: bool = True
    scheme: str = "lex"
    meta: dict = field(default_factory=dict)


def save_database(db: Database, path: str, compress: Optional[str] = None):
    """Write ``db`` as BTPU1, gzipped when ``compress == "gz"`` or the name
    ends in .gz (``load_database`` reads gzip by the name alone)."""
    header = dict(
        k=db.k,
        w=db.w,
        gaps=list(db.gaps),
        canonicalize=bool(db.canonicalize),
        scheme=db.scheme,
        n=int(db.table.n),
        val_dtype=str(db.table.vals_sorted.dtype),
        meta=db.meta,
    )
    hb = json.dumps(header).encode()
    opener = gzip.open if compress == "gz" or path.endswith(".gz") else open
    vals = np.asarray(db.table.vals_sorted)
    with opener(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<I", len(hb)))
        fh.write(hb)
        fh.write(np.asarray(db.table.keys_sorted).astype("<u8").tobytes())
        fh.write(vals.astype(vals.dtype.newbyteorder("<")).tobytes())


def read_database_arrays(path: str):
    """(header, keys, vals) of a BTPU1 file, or None if it is not one."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        if fh.read(len(MAGIC)) != MAGIC:
            return None
        (hlen,) = struct.unpack("<I", fh.read(4))
        header = json.loads(fh.read(hlen))
        n = header["n"]
        keys = np.frombuffer(fh.read(8 * n), dtype="<u8").astype(np.uint64)
        vdt = np.dtype(header["val_dtype"])
        vals = np.frombuffer(
            fh.read(vdt.itemsize * n), dtype=vdt.newbyteorder("<")
        ).astype(vdt)
    return header, keys, vals


def load_database(path: str) -> Database:
    got = read_database_arrays(path)
    if got is None:
        raise NotImplementedError(
            f"{path}: not a BTPU1 file; the reference khash image is not "
            "ported (ROADMAP queue A, item 10)"
        )
    header, keys, vals = got
    return Database(
        table=KmerTable(keys, vals),
        k=header["k"],
        w=header["w"],
        gaps=header["gaps"],
        canonicalize=header.get("canonicalize", True),
        scheme=header.get("scheme", "lex"),
        meta=header.get("meta", {}),
    )


# -- probe image ---------------------------------------------------------------

@dataclass
class ProbeImage:
    slots: np.ndarray  # (nb, 4) u64, memory-mapped
    vals: np.ndarray  # inline: (u,) u64 unique packed values; else (nb, 4)
    inline: bool
    lgnb: int
    vbits: int
    n: int
    n_distinct: int
    k: int
    w: int
    gaps: List[int]
    canonicalize: bool
    tree_digest: str


def tree_digest(tree) -> str:
    """Fingerprint of a TaxTree's structure: a probe image packs compact
    tree indices, so it is valid only with the tree it was built against."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(tree.tax_ids).tobytes())
    h.update(np.ascontiguousarray(tree.parent).tobytes())
    return h.hexdigest()[:16]


def packed_values(table: KmerTable, tree) -> np.ndarray:
    """The classifier's payload per key: original taxid << 32 | compact
    tree index, so that one probe yields both."""
    compact_vals = tree.compact(table.vals_sorted, missing_ok=True)
    return (
        table.vals_sorted.astype(np.uint64) << np.uint64(32)
    ) | compact_vals.astype(np.uint32).astype(np.uint64)


def save_probe_image(dirpath: str, db: Database, tree) -> None:
    table = db.table
    compact_vals = tree.compact(table.vals_sorted, missing_ok=True)
    slots, vals, inline = table.arrays_np(packed_values(table, tree))
    os.makedirs(dirpath, exist_ok=True)
    np.save(os.path.join(dirpath, "slots.npy"), slots)
    np.save(os.path.join(dirpath, "vals.npy"), np.asarray(vals))
    meta = dict(
        format="btpu-probe-image", version=1,
        inline=bool(inline), lgnb=table.lgnb, vbits=table.vbits,
        n=table.n, n_distinct=int(unique_u64(compact_vals).size),
        k=db.k, w=db.w, gaps=list(map(int, db.gaps)),
        canonicalize=bool(db.canonicalize),
        tree_digest=tree_digest(tree),
    )
    with open(os.path.join(dirpath, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def is_probe_image(path: str) -> bool:
    meta_p = os.path.join(path, "meta.json")
    if not (os.path.isdir(path) and os.path.exists(meta_p)):
        return False
    with open(meta_p) as fh:
        return json.load(fh).get("format") == "btpu-probe-image"


def load_probe_image(dirpath: str) -> ProbeImage:
    with open(os.path.join(dirpath, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("format") != "btpu-probe-image":
        raise ValueError(f"{dirpath}: not a probe image directory")
    slots = np.load(os.path.join(dirpath, "slots.npy"), mmap_mode="r")
    vals = np.load(os.path.join(dirpath, "vals.npy"), mmap_mode="r")
    return ProbeImage(
        slots=slots, vals=vals, inline=meta["inline"], lgnb=meta["lgnb"],
        vbits=meta["vbits"], n=meta["n"], n_distinct=meta["n_distinct"],
        k=meta["k"], w=meta["w"], gaps=meta["gaps"],
        canonicalize=meta["canonicalize"],
        tree_digest=meta["tree_digest"],
    )
