"""SetSketch LSH index: register-group keys -> sample id lists.

Counterpart of ``bonsai_tpu/sketch/ssi.py`` (the reference's
sketch::SetSketchIndex and bns::lsh::{write,read}_database, ssi.h:14-160),
host code: the index is a dict of at most a few thousand keys a sketch,
and its keys mix a sketch's registers four at a time.  The file it writes
is the JAX package's byte for byte:

    i32 k | u64 total_vals | u64 total_ids |
    u32 nids_per_key[total_vals] | u64 keys[total_vals] |
    u32 ids (concatenated, grouped per key, in insertion order)

through gzip where the name ends in ``.gz`` (the reference's gz reader
loses its keys, ssi.h:66-69,139; this one reads the stream as written).

The m registers are cut into groups of ``regs_per_hash`` consecutive
registers, and each group's registers are mixed with wang_hash (the plain
version of KS4's, ``core.hashes.wang_hash_plain``: a sketch has a few
thousand registers) into one u64 key, offset by the group's index;
samples that share a key agree on that whole group.
"""

from __future__ import annotations

import gzip
import struct
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.bitops import i64
from ..core.hashes import wang_hash_plain
from .setsketch import SetSketch

_SEED = i64(0x9A3298AFB5AC7173)
_GROUP_MUL = i64(0xC2B2AE3D27D4EB4F)


def _group_keys(registers: np.ndarray, regs_per_hash: int) -> np.ndarray:
    """(n_groups,) u64 keys, each mixing one group of consecutive
    registers (int64-held u64 arithmetic on CPU tensors)."""
    n_groups = registers.size // regs_per_hash
    r = torch.from_numpy(registers[: n_groups * regs_per_hash].astype(
        np.int64)).view(n_groups, regs_per_hash)
    acc = torch.full((n_groups,), _SEED, dtype=torch.int64)
    for j in range(regs_per_hash):
        acc = wang_hash_plain(acc ^ (r[:, j] + (j + 1)))
    # identical groups at different places take different keys
    acc = acc ^ (torch.arange(n_groups, dtype=torch.int64) * _GROUP_MUL)
    return acc.numpy().view(np.uint64)


class SetSketchIndex:
    def __init__(self, k: int = 0, regs_per_hash: int = 4):
        self.k = int(k)
        self.regs_per_hash = int(regs_per_hash)
        self.map: Dict[int, List[int]] = {}
        self.n_samples = 0

    def add(self, sketch_registers: np.ndarray, sample_id=None) -> int:
        sid = self.n_samples if sample_id is None else int(sample_id)
        for key in _group_keys(np.asarray(sketch_registers),
                               self.regs_per_hash):
            self.map.setdefault(int(key), []).append(sid)
        self.n_samples = max(self.n_samples, sid + 1)
        return sid

    def query(self, sketch_registers: np.ndarray) -> np.ndarray:
        """(n_samples,) collision counts (shared register groups)."""
        counts = np.zeros(self.n_samples, dtype=np.int64)
        for key in _group_keys(np.asarray(sketch_registers),
                               self.regs_per_hash):
            for sid in self.map.get(int(key), ()):
                if sid >= counts.size:
                    counts = np.pad(counts, (0, sid + 1 - counts.size))
                counts[sid] += 1
        return counts

    def topk(self, sketch_registers: np.ndarray, n: int = 10):
        """The n samples with the most shared groups, ties by sample id,
        as (id, count), those with none left out."""
        counts = self.query(sketch_registers)
        order = np.argsort(-counts, kind="stable")[:n]
        return [(int(i), int(counts[i])) for i in order if counts[i] > 0]

    def merge(self, other: "SetSketchIndex") -> "SetSketchIndex":
        """operator+= (ssi.h:122-130)."""
        for key, ids in other.map.items():
            self.map.setdefault(key, []).extend(ids)
        self.n_samples = max(self.n_samples, other.n_samples)
        return self

    # -- serialization (the reference's byte layout) ----------------------
    def write(self, path: str):
        op = gzip.open if path.endswith(".gz") else open
        keys = np.fromiter(self.map.keys(), dtype=np.uint64,
                           count=len(self.map))
        nids = np.fromiter((len(v) for v in self.map.values()),
                           dtype=np.uint32, count=len(self.map))
        with op(path, "wb") as fh:
            fh.write(struct.pack("<i", self.k))
            fh.write(struct.pack("<QQ", len(self.map), int(nids.sum())))
            fh.write(nids.tobytes())
            fh.write(keys.tobytes())
            for v in self.map.values():
                fh.write(np.asarray(v, dtype=np.uint32).tobytes())

    @classmethod
    def read(cls, path: str, regs_per_hash: int = 4) -> "SetSketchIndex":
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as fh:
            (k,) = struct.unpack("<i", fh.read(4))
            total_vals, _ = struct.unpack("<QQ", fh.read(16))
            nids = np.frombuffer(fh.read(4 * total_vals), dtype=np.uint32)
            keys = np.frombuffer(fh.read(8 * total_vals), dtype=np.uint64)
            idx = cls(k=k, regs_per_hash=regs_per_hash)
            maxid = -1
            for i in range(total_vals):
                ids = np.frombuffer(fh.read(4 * int(nids[i])), dtype=np.uint32)
                idx.map[int(keys[i])] = [int(x) for x in ids]
                if ids.size:
                    maxid = max(maxid, int(ids.max()))
            idx.n_samples = maxid + 1
            return idx


def build_index(sketches: Sequence[SetSketch], k: int = 0,
                regs_per_hash: int = 4) -> SetSketchIndex:
    idx = SetSketchIndex(k=k, regs_per_hash=regs_per_hash)
    for s in sketches:
        idx.add(s.registers)
    return idx
