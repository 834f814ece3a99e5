"""Database files: BTPU1, the classify-ready probe image, the sharded
directory and the reference binary's khash image.

Counterpart of ``bonsai_tpu/db/formats.py``, byte for byte: a file
written by either package loads in the other, and both write the same
bytes from the same database.

* BTPU1: magic + JSON header + raw little-endian sorted key and value
  arrays; the probe table is rebuilt by placement on load.
* probe image: a directory of ``slots.npy`` + ``vals.npy`` (the slot
  image already packed with the classifier's payload, memory-mapped on
  load) + ``meta.json``.
* sharded directory (``build --shards N|auto``): one BTPU1 file per
  hash-prefix shard (``shard_owner``, KS5 on the card), ``uniq_vals.npy``
  and a ``manifest.json`` that records the shards' common bucket count;
  ``load_database_sharded`` merges the shards again.
* the reference ``Database<khash_t(c)>`` / ``Database<khash_t(64)>``
  image (database.h:33-102, util.h:281-372; ``build --bonsai-format``):
  {u32 k, u32 w, (k-1) spacing bytes}, then a raw khash memory image {u64
  n_buckets, n_occupied, size, upper_bound; u32 flags[fsize]; u64
  keys[nb]; u32|u64 vals[nb]}.  The writer places the keys as klib's
  triangular probing does, in rounds in which the smallest key index
  wins a contested slot; ``load_database`` falls through to the reader
  for a file that is not BTPU1.  The spacing is written one byte a gap,
  as the reference does (database.h:48,99).
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

from ..core.spacer import Spacer
from ..util import span
from .table import (MAX_LOAD, SLOTS, HashShardedTable, KmerTable,
                    _next_pow2, owner_parts, owners_of, unique_u64)

MAGIC = b"BTPU1\n"
KH_UPPER = 0.77


class NotADatabase(ValueError):
    """A file that is neither BTPU1 nor a reference khash image."""


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

    @property
    def spacer(self) -> Spacer:
        return Spacer(self.k, self.w, self.gaps)


def _write_native(path: str, header: dict, keys: np.ndarray,
                  vals: np.ndarray, compress: Optional[str] = None):
    """Write one BTPU1 file, gzipped when ``compress == "gz"`` or the name
    ends in .gz (``load_database`` reads gzip by the name alone)."""
    hb = json.dumps(header).encode()
    opener = gzip.open if compress == "gz" or path.endswith(".gz") else open
    vals = np.asarray(vals)
    with opener(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<I", len(hb)))
        fh.write(hb)
        fh.write(np.asarray(keys).astype("<u8").tobytes())
        fh.write(vals.astype(vals.dtype.newbyteorder("<")).tobytes())


def _header(k, w, gaps, canonicalize, scheme, n, val_dtype, meta) -> dict:
    return dict(k=k, w=w, gaps=list(gaps), canonicalize=bool(canonicalize),
                scheme=scheme, n=int(n), val_dtype=str(val_dtype), meta=meta)


def save_database(db: Database, path: str, compress: Optional[str] = None):
    """Write ``db`` as BTPU1, gzipped when ``compress == "gz"`` or the name
    ends in .gz."""
    t = db.table
    _write_native(path, _header(db.k, db.w, db.gaps, db.canonicalize,
                                db.scheme, t.n, t.vals_sorted.dtype, db.meta),
                  t.keys_sorted, t.vals_sorted, compress)


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
    """A BTPU1 file, or else the reference binary's khash image."""
    got = read_database_arrays(path)
    if got is None:
        return import_bonsai_database(path)
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
    return payload(table.vals_sorted, tree)


def payload(vals: np.ndarray, tree) -> np.ndarray:
    """``packed_values`` of u32 taxids ``vals``."""
    with span("payload"):
        compact_vals = tree.compact(vals, missing_ok=True)
        return (
            np.asarray(vals).astype(np.uint64) << np.uint64(32)
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


# -- sharded directory -----------------------------------------------------------

# Each rank's slot array is kept under this budget by ``build --shards
# auto``: the JAX package measured its probe's row gathers flat in table
# size up to ~128 MB of slots on its TPU, and the port keeps the same
# policy so that both packages shard a database alike.  Where the H100's
# own gather cliff lies is not measured.
SHARD_SLOT_BUDGET = 128 << 20
SHARDED_FORMAT = "bonsai-tpu-sharded-v1"


def table_slot_bytes(n_kmers: int) -> int:
    """Slot-array bytes of a quotient-cuckoo table holding n_kmers."""
    nb = max(
        _next_pow2(max(int(np.ceil(n_kmers / (SLOTS * MAX_LOAD))), 1)), 4
    )
    return nb * SLOTS * 8


def recommended_shards(n_kmers: int,
                       budget_bytes: int = SHARD_SLOT_BUDGET) -> int:
    """The smallest power-of-two shard count (at most 65536) that keeps
    every rank's slot array within ``budget_bytes`` (``build --shards
    auto``)."""
    s = 1
    while table_slot_bytes(-(-n_kmers // s)) > budget_bytes and s < 65536:
        s *= 2
    return s


def is_sharded_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "manifest.json"))


def _write_shards(dirpath, keys, vals, parts, nb, ndb, k, w, gaps,
                  canonicalize, scheme, meta, compress, n):
    """The shard files, ``uniq_vals.npy`` and ``manifest.json`` of a
    sharded directory whose shard s holds ``keys[parts[s]]``."""
    os.makedirs(dirpath, exist_ok=True)
    ext = ".btpu.gz" if compress == "gz" else ".btpu"
    shard_files, shard_n = [], []
    for s in range(ndb):
        p = parts[s]
        fn = f"shard-{s:05d}{ext}"
        _write_native(os.path.join(dirpath, fn),
                      _header(k, w, gaps, canonicalize, scheme, p.size,
                              vals.dtype, meta),
                      keys[p], vals[p], compress)
        shard_files.append(fn)
        shard_n.append(int(p.size))
    np.save(os.path.join(dirpath, "uniq_vals.npy"), unique_u64(vals))
    manifest = dict(
        format=SHARDED_FORMAT,
        ndb=ndb,
        n=int(n),
        nb=int(nb),  # the shards' common bucket count: no growth on load
        shard_n=shard_n,
        k=k, w=w, gaps=list(gaps),
        canonicalize=bool(canonicalize), scheme=scheme,
        partition="splitmix64-prefix",  # shard_owner(key, ndb)
        shards=shard_files,
        uniq_vals="uniq_vals.npy",
        meta=meta,
    )
    with open(os.path.join(dirpath, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)


def save_database_sharded(db: Database, dirpath: str, ndb: int,
                          compress: Optional[str] = None,
                          device="cuda") -> None:
    """Write ``db`` as ``ndb`` hash-prefix shard files + ``uniq_vals.npy``
    (the database's distinct values) + ``manifest.json`` (the agreed
    common bucket count: every shard is placed at it here, so that a
    loader of one shard never needs another count).  The owners are
    computed on ``device`` (KS5 on the card)."""
    t = db.table
    ht = HashShardedTable(t, ndb, device)
    _write_shards(dirpath, t.keys_sorted, np.asarray(t.vals_sorted),
                  ht.parts, ht.nb, ndb, db.k, db.w, db.gaps, db.canonicalize,
                  db.scheme, db.meta, compress, t.n)


def save_sharded_arrays(keys: np.ndarray, vals: np.ndarray, dirpath: str,
                        ndb: int, k: int, w: int, gaps: List[int],
                        canonicalize: bool = True, scheme: str = "lex",
                        meta: Optional[dict] = None,
                        device="cuda") -> None:
    """The sharded directory of sorted, unique (keys, vals), without a
    placement of the whole table: the common bucket count is negotiated
    by placing one shard at a time (from the start again at a grown
    count).  The same files as ``save_database_sharded``."""
    keys = np.asarray(keys, dtype=np.uint64)
    vals = np.asarray(vals)
    if keys.ndim != 1 or keys.shape != vals.shape:
        raise ValueError("keys/vals must be matching 1-D arrays")
    if keys.size > 1 and not np.all(keys[1:] > keys[:-1]):
        raise ValueError("keys must be sorted and unique")
    owner = owners_of(keys, ndb, device)
    counts = np.bincount(owner, minlength=ndb)
    nb = max(
        _next_pow2(int(np.ceil(max(int(counts.max()), 1)
                               / (SLOTS * MAX_LOAD)))), 4
    )
    parts = owner_parts(owner, ndb)
    s = 0
    while s < ndb:
        got = KmerTable(keys[parts[s]], vals[parts[s]], min_nb=nb).nb
        if got != nb:
            nb = got
            s = 0
            continue
        s += 1
    _write_shards(dirpath, keys, vals, parts, nb, ndb, k, w, gaps,
                  canonicalize, scheme, meta or {}, None, keys.size)


def load_database_sharded(dirpath: str,
                          ranks: Optional[List[int]] = None) -> Database:
    """A sharded directory merged into one database (all shards, or those
    of ``ranks``): the shards' sorted keys interleave, so they are sorted
    again."""
    with open(os.path.join(dirpath, "manifest.json")) as fh:
        mf = json.load(fh)
    if mf.get("format") != SHARDED_FORMAT:
        raise ValueError(f"not a sharded DB dir: {dirpath}")
    which = range(mf["ndb"]) if ranks is None else ranks
    keys, vals = [], []
    for s in which:
        path = os.path.join(dirpath, mf["shards"][s])
        got = read_database_arrays(path)
        if got is None:
            raise ValueError(f"{path}: not a BTPU1 shard file")
        keys.append(got[1])
        vals.append(got[2])
    keys = np.concatenate(keys)
    vals = np.concatenate(vals)
    order = np.argsort(keys, kind="stable")
    return Database(
        table=KmerTable(keys[order], vals[order]), k=mf["k"], w=mf["w"],
        gaps=mf["gaps"], canonicalize=mf.get("canonicalize", True),
        scheme=mf.get("scheme", "lex"), meta=mf.get("meta", {}),
    )


# -- the reference khash image ------------------------------------------------------

def _kh_hash(keys: np.ndarray) -> np.ndarray:
    """klib khash's int64 hash truncated to u32 (khash64.h:425)."""
    k = keys.astype(np.uint64)
    return ((k >> np.uint64(33)) ^ k ^ (k << np.uint64(11))) & np.uint64(
        0xFFFFFFFF)


def _kroundup64(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def _fsize(nb: int) -> int:
    return 1 if nb < 16 else nb >> 4


def read_bonsai_database(path: str):
    """A reference Database file -> (k, w, gaps, keys, vals, val_width):
    the occupied slots' keys sorted, with their values; the value width
    (4 for khash_t(c), 8 for khash_t(64)) from the file's size.  Raises
    ValueError for a file that is not such an image."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        data = fh.read()
    bad = NotADatabase(f"{path}: neither a BTPU1 file nor a reference "
                       "khash database image")
    if len(data) < 8:
        raise bad
    k, w = struct.unpack_from("<II", data, 0)
    off = 8 + k - 1
    if not 1 <= k <= 64 or len(data) < off + 32:
        raise bad
    gaps = list(data[8:off])
    nb, n_occ, size, upper = struct.unpack_from("<QQQQ", data, off)
    off += 32
    if nb < 1 or nb & (nb - 1):
        raise bad
    fs = _fsize(nb)
    remaining = len(data) - off - 4 * fs - 8 * nb
    if remaining not in (4 * nb, 8 * nb):
        raise bad
    flags = np.frombuffer(data, dtype="<u4", count=fs, offset=off)
    off += 4 * fs
    keys = np.frombuffer(data, dtype="<u8", count=nb, offset=off)
    off += 8 * nb
    val_width = 8 if remaining >= 8 * nb else 4
    vals = np.frombuffer(data, dtype=f"<u{val_width}", count=nb, offset=off)
    # occupied slots: 2-bit flag == 0 (khash64.h:169-171)
    idx = np.arange(nb)
    fl = (flags[idx >> 4] >> ((idx & 0xF) << 1).astype(np.uint32)) & 3
    occ = fl == 0
    okeys = keys[occ].astype(np.uint64)
    ovals = vals[occ]
    order = np.argsort(okeys, kind="stable")
    return int(k), int(w), gaps, okeys[order], ovals[order], val_width


def import_bonsai_database(path: str) -> Database:
    k, w, gaps, keys, vals, vw = read_bonsai_database(path)
    if keys.size > 1 and not np.all(keys[1:] > keys[:-1]):
        raise ValueError(f"{path}: duplicate keys in khash image")
    return Database(
        table=KmerTable(keys, vals),
        k=k,
        w=w,
        gaps=gaps,
        meta=dict(source="bonsai", val_width=vw),
    )


def _khash_layout(keys: np.ndarray, vals: np.ndarray):
    """klib khash's slot layout of sorted unique keys: every key walks its
    triangular probe sequence (kh_put, khash64.h), in rounds; in each
    round the smallest index among the unplaced keys that target an
    empty slot wins it, and the others take one more probe step.  The
    written bytes depend on this order."""
    n = keys.size
    nb = _kroundup64(max(n, 4))
    while n >= int(nb * KH_UPPER + 0.5):
        nb <<= 1
    mask = np.uint64(nb - 1)
    slot_keys = np.zeros(nb, dtype=np.uint64)
    slot_vals = np.zeros(nb, dtype=vals.dtype)
    occupied = np.zeros(nb, dtype=bool)
    if n:
        pos = (_kh_hash(keys) & mask).astype(np.int64)
        step = np.zeros(n, dtype=np.int64)
        alive = np.ones(n, dtype=bool)
        ids = np.arange(n)
        while alive.any():
            ai = ids[alive]
            cand = pos[ai]
            empty = ~occupied[cand]
            ei = ai[empty]
            cand_e = cand[empty]
            _, first = np.unique(cand_e, return_index=True)
            winners = ei[first]
            slot_keys[pos[winners]] = keys[winners]
            slot_vals[pos[winners]] = vals[winners]
            occupied[pos[winners]] = True
            alive[winners] = False
            rest = alive.copy()
            step[rest] += 1
            pos[rest] = (pos[rest] + step[rest]) & np.int64(nb - 1)
    return nb, slot_keys, slot_vals, occupied


def write_bonsai_database(db: Database, path: str, compress: bool = False):
    """Write ``db`` as the reference ``Database<khash_t(T)>`` image, T from
    the value dtype (u32 -> khash_t(c), u64 -> khash_t(64)); gzipped with
    ``compress`` or a .gz name."""
    keys = db.table.keys_sorted
    vals = db.table.vals_sorted
    nb, sk, sv, occ = _khash_layout(keys, vals)
    n = keys.size
    flags = np.full(_fsize(nb), 0xAAAAAAAA, dtype=np.uint32)
    idx = np.nonzero(occ)[0]
    # clear both bits of every occupied slot
    clear = (np.uint32(3) << ((idx & 0xF) << 1).astype(np.uint32)).astype(
        np.uint32)
    np.bitwise_and.at(flags, idx >> 4, ~clear)
    upper = int(nb * KH_UPPER + 0.5)
    opener = gzip.open if compress or path.endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(struct.pack("<II", db.k, db.w))
        fh.write(bytes((g & 0xFF) for g in db.gaps))
        fh.write(struct.pack("<QQQQ", nb, n, n, upper))
        fh.write(flags.astype("<u4").tobytes())
        fh.write(sk.astype("<u8").tobytes())
        fh.write(sv.astype(sv.dtype.newbyteorder("<")).tobytes())
