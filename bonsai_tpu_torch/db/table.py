"""Quotient-cuckoo k-mer table: built on the host, probed on the device.

Counterpart of ``bonsai_tpu/db/table.py``, with the same slot image bit
for bit, so that a table built or saved by either package probes alike
in both.  A probe is two 32-byte row reads and one value read:

    h  = splitmix64(kmer)            (bijective)
    b1 = h & (nb-1),  q = h >> lg(nb)
    b2 = b1 ^ (splitmix64(q ^ BSALT) & (nb-1))

* a slot is one u64 [occupied:1 | choice:1 | q | val_idx:vbits], with
  vbits = lg(nb) - 2; empty slots are 0 and never match;
* inline mode: val_idx indexes a small sorted unique-values array;
  flat mode: a parallel (nb, 4) value array, read at the matched slot.

Placement is the host C++ cuckoo placer (``btpu_cuckoo_place``).  On
the device the slot and value arrays are int64 tensors holding u64 bits.

``ScoreMap`` is the score::Hash order of the hash-scored phase 2
(``build -t/-f --phase1-db``): each k-mer's packed phase-1 value, probed
by KB5 ``lookup_scores`` (``csrc/lookup_scores.cu``) on the card and by
``lookup_scores_plain`` on CPU tensors.

``shard_owner`` is the hash-prefix shard of a key, which partitions a
sharded database directory (``HashShardedTable``, ``db/formats.py``): KS5
(``csrc/bitmix.cu``, entry ``bk_shard_owner``) on the card,
``shard_owner_plain`` on CPU tensors and ``shard_owner_np`` on host
arrays.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import kernels
from ..core import hashes
from ..core.bitops import SIGN, as_keys, i64, shr
from ..util import span

SLOTS = 4
BSALT = 0xA24BAED4963EE407
MAX_LOAD = 0.87

_OCC = np.uint64(1) << np.uint64(63)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 0)


def unique_u64(a) -> np.ndarray:
    """Sorted distinct values of a non-negative integer array, as u64,
    through the host C++ radix sort-dedup (``np.unique`` of 6.7e7 u64
    values took 200 s under numpy 2.3.5 on an H100 host, where the cuckoo
    placement of the same keys took 3 s)."""
    from ..native import get_lib

    a = np.array(a, dtype=np.uint64, copy=True).ravel()
    if not a.size:
        return a
    m = get_lib().btpu_sort_dedup_u64(a.ctypes.data, a.size)
    return a[:m].copy()


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 on a host u64 array (the placer's and probe_np's hash)."""
    u = np.uint64
    x = np.asarray(x, dtype=np.uint64) + u(0x9E3779B97F4A7C15)
    x = (x ^ (x >> u(30))) * u(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> u(27))) * u(0x94D049BB133111EB)
    return x ^ (x >> u(31))


class KmerTable:
    """``keys_sorted`` / ``vals_sorted`` are the content (sorted by key);
    the slot layout is derived from them by the placer."""

    def __init__(self, keys_sorted: np.ndarray, vals_sorted: np.ndarray,
                 load_factor: float = MAX_LOAD, min_nb: int = 0):
        with span("placement"):
            keys_sorted = np.asarray(keys_sorted, dtype=np.uint64)
            vals_sorted = np.asarray(vals_sorted)
            if (keys_sorted.ndim != 1
                    or keys_sorted.shape != vals_sorted.shape):
                raise ValueError("keys/vals must be matching 1-D arrays")
            if keys_sorted.size > 1 and not np.all(
                    keys_sorted[1:] > keys_sorted[:-1]):
                raise ValueError("keys must be sorted and unique")
            self.keys_sorted = keys_sorted
            self.vals_sorted = vals_sorted
            self.n = int(keys_sorted.size)
            self._h = splitmix64_np(keys_sorted)
            nb = max(
                _next_pow2(max(int(np.ceil(self.n / (SLOTS * load_factor))),
                               1)),
                4,
                _next_pow2(min_nb) if min_nb else 4,
            )
            while not self._place(nb):
                nb <<= 1
            self._h = None  # placement done; the slot words keep q
            self._np_arrays = None  # arrays_np() of the table's own values

    def trim(self) -> None:
        """Free the placement's host arrays (each slot's owner and the
        placed keys' slot words) and the kept ``arrays_np`` image: the
        classifier calls it once the image is on the device.  Any later
        use rebuilds them by the same deterministic placement at the same
        bucket count (``KmerTable.trim`` of the JAX package)."""
        self._occ = self._own = self._word = None
        self._np_arrays = None

    def _layout(self) -> None:
        """Place the keys again after ``trim``."""
        if self._occ is None:
            with span("placement"):
                self._h = splitmix64_np(self.keys_sorted)
                if not self._place(self.nb):
                    raise RuntimeError(f"KmerTable: the placement at nb="
                                       f"{self.nb} failed on its rebuild")
                self._h = None

    def lookup(self, key: int):
        """The value of ``key``, or None where the table lacks it."""
        i = int(np.searchsorted(self.keys_sorted, np.uint64(key)))
        if i < self.n and self.keys_sorted[i] == np.uint64(key):
            return self.vals_sorted[i]
        return None

    def _place(self, nb: int, max_walk: int = 500) -> bool:
        from ..native import get_lib

        self.nb = nb
        self.lgnb = int(np.log2(nb))
        self.vbits = max(self.lgnb - 2, 0)
        owner = np.full(nb * SLOTS, -1, dtype=np.int64)
        choice = np.zeros(nb * SLOTS, dtype=np.uint8)
        if self.n:
            rc = get_lib().btpu_cuckoo_place(
                self._h.ctypes.data, self.n, nb, BSALT, max_walk,
                owner.ctypes.data, choice.ctypes.data,
            )
            if rc != 0:
                return False
        occ = owner >= 0
        own = owner[occ]
        self._occ = occ
        self._own = own
        # the quotient of every placed key, with its choice bit and the
        # occupied bit: the slot word before its value index is or-ed in
        self._word = (
            _OCC
            | (choice[occ].astype(np.uint64) << np.uint64(62))
            | ((self._h[own] >> np.uint64(self.lgnb)) << np.uint64(self.vbits))
        )
        return True

    def arrays_np(self, vals_aligned: Optional[np.ndarray] = None):
        """(slots (nb, 4) u64, vals, inline) for values aligned to
        ``keys_sorted`` (default: the table's own values).  Inline mode
        when the distinct values fit the slot's index field: vals is the
        sorted (u,) unique-values array; otherwise the flat (nb, 4) array.
        The image of the table's own values is made once and kept (as the
        JAX package keeps it): a phase-1 map's is both uploaded and probed
        on the host."""
        if vals_aligned is None and self._np_arrays is not None:
            return self._np_arrays
        out = self.encode_slots(
            self.vals_sorted if vals_aligned is None else vals_aligned)
        if vals_aligned is None:
            self._np_arrays = out
        return out

    def encode_slots(self, vals_aligned: np.ndarray,
                     uniq: Optional[np.ndarray] = None,
                     allow_inline: bool = True):
        """``arrays_np`` of ``vals_aligned`` (``KmerTable._encode_slots``
        of the JAX package): ``uniq`` is a shared sorted unique-values
        array (every shard of a sharded table encodes against one, so
        that a value index means the same on every rank), and
        ``allow_inline=False`` forces the flat value array."""
        self._layout()
        with span("image"):
            v64 = np.asarray(vals_aligned).astype(np.uint64)
            if uniq is None:
                uniq = unique_u64(v64) if self.n else np.zeros(1, np.uint64)
            if uniq.size == 0:
                uniq = np.zeros(1, np.uint64)
            inline = allow_inline and uniq.size <= (1 << self.vbits)
            words = np.zeros(self.nb * SLOTS, dtype=np.uint64)
            if inline:
                validx = np.searchsorted(uniq, v64[self._own]).astype(
                    np.uint64)
                words[self._occ] = self._word | validx
                return words.reshape(self.nb, SLOTS), uniq, True
            words[self._occ] = self._word
            flat = np.zeros(self.nb * SLOTS, dtype=np.uint64)
            flat[self._occ] = v64[self._own]
            return (words.reshape(self.nb, SLOTS),
                    flat.reshape(self.nb, SLOTS), False)

    def probe_np(self, queries: np.ndarray, arrays=None):
        """Host probe of u64 queries -> (vals in the table's dtype, found)."""
        slots, vals, inline = arrays if arrays is not None else self.arrays_np()
        return probe_np(queries, slots, vals, inline, self.lgnb,
                        self.vbits, self.vals_sorted.dtype)

    def __len__(self):
        return self.n


def probe_np(queries, slots, vals, inline, lgnb, vbits, dtype=np.uint64):
    """Host numpy probe of a slot image (``KmerTable.probe_np`` of the JAX
    package): the independent check of the device probe."""
    u = np.uint64
    q_in = np.asarray(queries, dtype=np.uint64)
    h = splitmix64_np(q_in)
    mask = u((1 << lgnb) - 1)
    b1 = h & mask
    q = h >> u(lgnb)
    b2 = b1 ^ (splitmix64_np(q ^ u(BSALT)) & mask)
    vmask = u((1 << vbits) - 1)
    base = u(1 << 63) | (q << u(vbits))
    lane = np.arange(SLOTS, dtype=np.int64)
    found = np.zeros(q_in.shape, dtype=bool)
    val = np.zeros(q_in.shape, dtype=np.uint64)
    for b, e in ((b1, base), (b2, base | u(1 << 62))):
        b = b.astype(np.int64)
        row = slots[b]
        m = (row & ~vmask) == e[..., None]
        hit = m.any(-1)
        if inline:
            vi = ((row & vmask) * m).sum(-1)
            v = vals[np.minimum(vi, vals.size - 1).astype(np.int64)]
        else:
            pos = ((b[..., None] * SLOTS + lane) * m).sum(-1)
            v = vals.reshape(-1)[pos]
        val = np.where(hit & ~found, v, val)
        found |= hit
    return val.astype(dtype), found


@dataclass
class ProbeArrays:
    """A slot image on a device: ``slots`` (nb, 4) and ``vals`` ((u,)
    inline or (nb, 4) flat) are int64 tensors holding u64 bits.  With
    ``rows`` > 0 it holds only rows [row0, row0 + rows) of a table of
    2^lgnb rows (a psum-route rank's range, ``parallel/sharded.py``):
    ``slots`` and flat ``vals`` are (rows, 4), a bucket outside the range
    misses, and a flat position is local."""

    slots: torch.Tensor
    vals: torch.Tensor
    inline: bool
    lgnb: int
    vbits: int
    row0: int = 0
    rows: int = 0

    @classmethod
    def from_numpy(cls, slots, vals, inline, lgnb, vbits, device,
                   row0: int = 0, rows: int = 0):
        def up(a, chunk=1 << 23):
            # row chunks: a memory-mapped probe image uploads without a
            # whole host copy
            a = np.asarray(a, dtype=np.uint64)
            out = torch.empty(a.shape, dtype=torch.int64, device=device)
            for i in range(0, max(a.shape[0], 1), chunk):
                piece = np.array(a[i : i + chunk]).view(np.int64)
                out[i : i + chunk].copy_(torch.from_numpy(piece))
            return out

        slots = np.asarray(slots)
        if slots.ndim != 2 or slots.shape[1] != SLOTS:
            raise ValueError(f"slots must be (nb, {SLOTS}), got {slots.shape}")
        if slots.shape[0] != (rows or 1 << lgnb):
            raise ValueError(f"slots has {slots.shape[0]} rows, lgnb={lgnb}, "
                             f"range of {rows}")
        return cls(up(slots), up(vals), bool(inline), int(lgnb), int(vbits),
                   int(row0), int(rows))

    def check(self, device, ranged: bool = False) -> None:
        """Raise unless the image is one a kernel on ``device`` can probe
        (a row range only where ``ranged``)."""
        if self.rows and not ranged:
            raise ValueError("a row range of a table: only the psum route's "
                             "probe takes it")
        nb = self.rows or 1 << self.lgnb
        kernels.check(self.slots, "slots", torch.int64, device, (nb, SLOTS))
        kernels.check(self.vals, "vals", torch.int64, device)
        if self.slots.data_ptr() % 16:
            raise ValueError("slots must be 16-byte aligned")
        if not self.inline and tuple(self.vals.shape) != (nb, SLOTS):
            raise ValueError(f"flat vals must be ({nb}, {SLOTS})")

    def args(self):
        """The image as a kernel's arguments: slots, lgnb, vbits, vals,
        n_vals, inline."""
        return (self.slots.data_ptr(), self.lgnb, self.vbits,
                self.vals.data_ptr(), self.vals.numel(), int(self.inline))


def split(h: torch.Tensor, lgnb: int):
    """(b1, q, b2) for hashed keys (``KmerTable._split``)."""
    mask = (1 << lgnb) - 1
    b1 = h & mask
    q = shr(h, lgnb)
    b2 = b1 ^ (hashes.splitmix64(q ^ i64(BSALT)) & mask)
    return b1, q, b2


def probe_slots(queries: torch.Tensor, arr: ProbeArrays,
                want_idx: bool = False):
    """Plain torch probe (``probe_slots_device`` of the JAX package):
    (...,) int64-held u64 queries -> (packed value int64, found bool
    [, sel int64]).  ``sel`` is the u32 value index (inline) or the u32
    flat slot position ``bucket*4 + lane`` (flat) of the match, 0 when not
    found."""
    h = hashes.splitmix64(queries)
    b1, q, b2 = split(h, arr.lgnb)
    vmask = (1 << arr.vbits) - 1
    base = SIGN | (q << arr.vbits)
    lane = torch.arange(SLOTS, device=queries.device)
    found = torch.zeros(queries.shape, dtype=torch.bool, device=queries.device)
    sel = torch.zeros(queries.shape, dtype=torch.int64, device=queries.device)
    pos = torch.zeros_like(sel)  # 64-bit flat position of the match
    for b, e in ((b1, base), (b2, base | (1 << 62))):
        if arr.rows:  # a rank's range: local rows, foreign buckets miss
            b = b - arr.row0
            mine = (b >= 0) & (b < arr.rows)
            b = b.clamp(0, arr.rows - 1)
            row = torch.where(mine[..., None], arr.slots[b], 0)
        else:
            row = arr.slots[b]
        m = (row & ~vmask) == e[..., None]
        hit = m.any(-1)
        first = hit & ~found
        if arr.inline:
            s = torch.where(m, row & vmask, 0).sum(-1)
        else:
            p = torch.where(m, b[..., None] * SLOTS + lane, 0).sum(-1)
            pos = torch.where(first, p, pos)
            s = p
        sel = torch.where(first, s & 0xFFFFFFFF, sel)  # u32, as in JAX
        found = found | hit
    flat = arr.vals.reshape(-1)
    # flat mode reads at the 64-bit position: exact past 2^31 slots, where
    # the JAX probe's int32 index would wrap
    idx = sel if arr.inline else pos
    val = flat[idx.clamp(0, flat.numel() - 1)]
    val = torch.where(found, val, 0)
    if want_idx:
        return val, found, torch.where(found, sel, 0)
    return val, found


# -- KB5: the phase-1 score of each k-mer ---------------------------------------

def lookup_scores_plain(kmers: torch.Tensor, arr: ProbeArrays) -> torch.Tensor:
    """Plain torch KB5: (...,) int64-held u64 k-mers -> their packed
    values in ``arr``, U64_MAX (int64 -1) where a k-mer is missing."""
    val, found = probe_slots(kmers, arr)
    return torch.where(found, val, -1)


def lookup_scores(kmers: torch.Tensor, arr: ProbeArrays) -> torch.Tensor:
    """KB5 (``csrc/lookup_scores.cu``): see ``lookup_scores_plain``, which
    serves CPU tensors.  kmers int64 of any shape -> scores of that shape,
    one probe a k-mer (``csrc/probe.cuh``)."""
    if kmers.device.type == "cpu":
        return lookup_scores_plain(kmers, arr)
    if kmers.device.type != "cuda":
        raise ValueError(f"lookup_scores: no kernel for device {kmers.device}")
    dev = kmers.device
    kernels.check(kmers, "kmers", torch.int64, dev)
    arr.check(dev)
    out = torch.empty_like(kmers)
    if kmers.numel():
        kernels.launch("bk_lookup_scores", dev, kmers.data_ptr(),
                       kmers.numel(), *arr.args(), out.data_ptr())
        lookup_scores.launches += 1
    return out


lookup_scores.launches = 0


class ScoreMap:
    """score::Hash adapter (``bonsai_tpu/db/table.py`` ``ScoreMap``): the
    phase-1 map as a minimizer order.  A k-mer scores its packed phase-1
    value, or U64_MAX when phase 1 lacks it, so that it never wins a
    window against one that phase 1 holds (encoder.h:61-74 as intended)."""

    def __init__(self, table: KmerTable):
        self.table = table
        self._arrays = {}  # torch.device -> ProbeArrays
        self._lock = threading.Lock()

    def arrays(self, device) -> ProbeArrays:
        """The phase-1 probe image on ``device``, uploaded once."""
        dev = torch.device(device)
        with self._lock:
            if dev not in self._arrays:
                t = self.table
                self._arrays[dev] = ProbeArrays.from_numpy(
                    *t.arrays_np(), t.lgnb, t.vbits, dev)
            return self._arrays[dev]

    def lookup_scores(self, kmers):
        """numpy u64 -> u64 scores (``probe_np``); an int64 tensor of u64
        bits -> int64 scores (KB5 on the card, its plain version on the
        CPU)."""
        if isinstance(kmers, np.ndarray):
            val, found = self.table.probe_np(kmers)
            return np.where(found, val.astype(np.uint64),
                            np.uint64((1 << 64) - 1))
        return lookup_scores(kmers, self.arrays(kmers.device))


# -- KS5: the hash-prefix shard owner of a key --------------------------------

def _check_ndb(ndb: int) -> int:
    ndb = int(ndb)
    if not 1 <= ndb < 1 << 31:
        raise ValueError(f"ndb={ndb}: the owner is an int32 in [0, ndb), "
                         "1 <= ndb < 2^31")
    return ndb


def shard_owner_np(kmers, ndb: int) -> np.ndarray:
    """Host numpy ``shard_owner``: u64 keys -> int32 owners."""
    h = splitmix64_np(kmers)
    u = np.uint64
    return (((h >> u(32)) * u(_check_ndb(ndb))) >> u(32)).astype(np.int32)


def shard_owner_plain(kmers: torch.Tensor, ndb: int) -> torch.Tensor:
    """Plain torch KS5: int64-held u64 keys of any shape -> int32 owners
    ((splitmix64(key) >> 32) * ndb) >> 32, both shifts logical (the
    product wraps mod 2^64 as the u64 one does)."""
    h = hashes.splitmix64(kmers)
    return shr(shr(h, 32) * _check_ndb(ndb), 32).to(torch.int32)


def shard_owner(kmers, ndb: int):
    """Hash-prefix shard owner of each key, in [0, ndb) (``shard_owner``
    of ``bonsai_tpu/db/table.py``: a fixed-point range partition of
    splitmix64's top 32 bits, disjoint from the low bucket bits).  A
    numpy array goes to ``shard_owner_np``, a CPU tensor to
    ``shard_owner_plain`` and a CUDA tensor to KS5 (``csrc/bitmix.cu``
    ``bk_shard_owner``: 8 B in and 4 B out a key)."""
    if isinstance(kmers, np.ndarray):
        return shard_owner_np(kmers, ndb)
    if kmers.device.type == "cpu":
        return shard_owner_plain(kmers, ndb)
    if kmers.device.type != "cuda":
        raise ValueError(f"shard_owner: no kernel for device {kmers.device}")
    ndb = _check_ndb(ndb)
    kernels.check(kmers, "kmers", torch.int64, kmers.device)
    out = torch.empty(kmers.shape, dtype=torch.int32, device=kmers.device)
    if kmers.numel():
        kernels.launch("bk_shard_owner", kmers.device, kmers.data_ptr(),
                       kmers.numel(), ndb, out.data_ptr())
        shard_owner.launches += 1
    return out


shard_owner.launches = 0


def owners_of(keys: np.ndarray, ndb: int, device) -> np.ndarray:
    """int32 owners of host u64 keys, computed on ``device`` (KS5 on the
    card, its plain version on the CPU)."""
    return shard_owner(as_keys(keys, device), ndb).cpu().numpy()


def owner_parts(owner: np.ndarray, ndb: int) -> List[np.ndarray]:
    """The indices of each owner's keys, ascending: one stable argsort
    instead of ndb scans of the owner array."""
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(owner[order],
                             np.arange(ndb + 1, dtype=owner.dtype))
    return [order[bounds[s]:bounds[s + 1]] for s in range(ndb)]


class HashShardedTable:
    """ndb independent quotient-cuckoo sub-tables partitioned by hash
    prefix (``HashShardedTable`` of ``bonsai_tpu/db/table.py``, its
    constructor): every key lives on shard ``shard_owner(key, ndb)``, and
    every shard is placed at one common bucket count ``nb``, negotiated
    by placing them all again at the grown ``nb`` whenever one needs
    more.  ``parts[s]`` are the indices of shard s's keys in the table's
    sorted keys (so each shard's keys stay sorted).  The owners are
    computed on ``device``.  A placed shard is dropped once its bucket
    count is read (the writers need only ``parts`` and ``nb``); a caller
    that needs the placed shards (the classifier) takes each one from
    ``on_placed(s, shard, part)``, called for every shard placed at the
    round's ``nb``: a later round, after a growth, calls it again for
    every shard, so the last call for each ``s`` is the one at the agreed
    ``nb``.  ``arrays_np`` places the shards again."""

    def __init__(self, table: KmerTable, ndb: int, device="cuda",
                 on_placed=None):
        if ndb < 1:
            raise ValueError("ndb must be >= 1")
        self.ndb = ndb
        self.table = table
        keys, vals = table.keys_sorted, table.vals_sorted
        self.parts: List[np.ndarray] = owner_parts(
            owners_of(keys, ndb, device), ndb)
        nmax = max(max((p.size for p in self.parts), default=0), 1)
        nb = max(_next_pow2(int(np.ceil(nmax / (SLOTS * MAX_LOAD)))), 4)
        while True:
            got = nb
            for s, p in enumerate(self.parts):
                shard = KmerTable(keys[p], vals[p], min_nb=nb)
                got = max(got, shard.nb)
                if on_placed is not None and shard.nb == nb:
                    on_placed(s, shard, p)
                del shard  # one placed shard held at a time
            if got == nb:
                break
            nb = got  # a shard needed growth: place all at the same nb
        self.nb = nb
        self.lgnb = int(nb).bit_length() - 1
        self.vbits = max(self.lgnb - 2, 0)

    def arrays_np(self, vals_aligned: np.ndarray):
        """(slots (ndb, nb, 4) u64, vals, inline) for values aligned to the
        table's keys (``HashShardedTable.arrays_np`` of the JAX package):
        in inline mode ``vals`` is the one global unique-values array,
        otherwise the stacked (ndb, nb, 4) flat value arrays."""
        v64 = np.asarray(vals_aligned).astype(np.uint64)
        uniq = unique_u64(v64) if v64.size else np.zeros(1, np.uint64)
        keys, vals = self.table.keys_sorted, self.table.vals_sorted
        got = [KmerTable(keys[p], vals[p], min_nb=self.nb).encode_slots(
            v64[p], uniq=uniq) for p in self.parts]
        inline = got[0][2]
        vals = uniq if inline else np.stack([g[1] for g in got])
        return np.stack([g[0] for g in got]), vals, inline
