"""The sharded classifier, its per-rank images and per-rank output, and
the sequence-parallel encode.

Counterpart of ``bonsai_tpu/parallel/sharded.py``.  Reads shard over the
mesh's ``dp`` axis and the database over ``db`` (``parallel/mesh.py``),
with the JAX package's two routes:

* ``a2a`` (default when ndb > 1): the table is split by hash prefix into
  ndb sub-tables (``db/table.py`` ``HashShardedTable``); the reads shard
  over both axes, each rank encodes its reads (K1's encode-only
  instantiation), routes each valid query to its owner over ``db`` and
  probes what it receives (KD1, ``parallel/route.py``: frame,
  ``all_to_all``, probe, ``all_to_all``, collect), in rounds until no
  rank has a query pending (the owners' capacity, ``capacity_factor``,
  bounds a round);
* ``psum``: rank s of the ``db`` axis holds rows [s * rows, (s + 1) *
  rows) of the one global table, padded to ndb * ceil(nb / ndb) rows;
  the reads shard over ``dp`` only and repeat over ``db``; each rank
  probes the buckets in its range (K1's bucket-range instantiation) and
  one ``psum`` over ``db`` merges (compact index, output value, found).

Reads of an input type other than DNA (``input_type``) go as int8 codes
(the channel "codes" of ``Classifier._prepare_batch``) to K1's radix
instantiations: encode-only on the a2a route, the bucket range on the
psum route.

Then each rank resolves (K2) and packs its rows (K3), and the compact
output is the ranks' outputs in rank order, byte-identical to the
one-device ``Classifier``'s; the host pipeline (``process_dataset``) is
``Classifier``'s, unchanged.  Several ranks may share one device (the
CPU tests, the one-card smoke); there they run one after another, so a
rate measured so is not a multi-device rate.

``from_sharded_dir`` loads a ``build --shards N`` directory a rank at a
time, from per-rank memory images (``bake_rank_images``) where they
match.  An image directory records a fingerprint of the shard files (the
manifest's sha256, and each shard file's and ``uniq_vals.npy``'s size and
mtime), and a loader ignores images whose fingerprint differs: the JAX
loader serves images of shards rebuilt in place (ADVICE r5).
"""

from __future__ import annotations

import concurrent.futures
import glob
import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..classify import output as out_mod
from ..classify.pipeline import (Classifier, encode_only, encode_only_radix,
                                 encode_probe, encode_probe_radix,
                                 step_outputs)
from ..classify.resolve import resolve
from ..core.alphabet import InputType
from ..core.encoder import minimizers
from ..db import formats
from ..db.table import (MAX_LOAD, SLOTS, HashShardedTable, KmerTable,
                        ProbeArrays, _next_pow2, unique_u64)
from ..io import fastx
from ..util import span
from .mesh import Mesh
from .route import route_collect, route_frame, route_probe


def _pad_rows_pow2(nb: int, ndb: int) -> int:
    """Rows a psum-route rank holds: ceil(nb / ndb)."""
    return (nb + ndb - 1) // ndb


class ShardedClassifier(Classifier):
    """Classify over a ``Mesh`` of ranks (``dp`` x ``db``); see the module
    docstring.  ``capacity_factor`` sizes a round of the a2a route
    (ceil(Q / ndb * capacity_factor) queries an owner a rank); ``step``
    gives the JAX package's raw 6-tuple, ``process_dataset`` the Kraken
    text."""

    def __init__(self, db: formats.Database, tree, mesh: Mesh,
                 canonicalize: bool = True,
                 input_type: InputType = InputType.DNA, route: str = "auto",
                 capacity_factor: float = 1.05, emit_all: bool = False,
                 emit_kraken: bool = True, emit_fastq: bool = False,
                 max_runs: int = 8):
        self.mesh = mesh
        self.ndb = mesh.shape.get("db", 1)
        self.ndp = mesh.shape.get("dp", 1)
        if route == "auto":
            route = "a2a" if self.ndb > 1 else "psum"
        if route not in ("a2a", "psum"):
            raise ValueError(f"unknown route {route!r}")
        self.route = route
        self._init_host(db.k, db.gaps, canonicalize, tree, capacity_factor,
                        emit_all, emit_kraken, emit_fastq, max_runs,
                        input_type)
        table = db.table
        packed = formats.packed_values(table, tree)
        if self._a2a:
            # routed responses pack (found:1 | compact:31) in the low word
            if tree.tin.size >= 1 << 31:
                raise ValueError("taxonomy too large for the 31-bit compact "
                                 "index in the a2a response word")
            uniq = unique_u64(packed) if packed.size else np.zeros(
                1, np.uint64)
            needed = {mesh.index(r, "db") for r in mesh.local_ranks}
            images = {}

            def encode(s, shard, part):  # each shard placed once
                if s in needed:
                    images[s] = shard.encode_slots(packed[part], uniq=uniq)

            ht = HashShardedTable(table, self.ndb, self.device, encode)
            self.lgnb, self.vbits = ht.lgnb, ht.vbits
            self._upload(images.__getitem__)
            images.clear()
        else:
            nb = table.nb
            rps = _pad_rows_pow2(nb, self.ndb)
            slots, vals, inline = table.arrays_np(packed)
            self.lgnb, self.vbits = table.lgnb, table.vbits

            def rows(s):
                lo, hi = s * rps, min((s + 1) * rps, nb)
                pad = rps - max(hi - lo, 0)
                sl = slots[lo:hi]
                fv = vals if inline else vals[lo:hi]
                if pad:  # all-zero slot words never match
                    z = np.zeros((pad, SLOTS), np.uint64)
                    sl = np.concatenate([sl, z])
                    if not inline:
                        fv = np.concatenate([fv, z])
                return sl, fv, inline

            self._upload(rows, rps)
        self._n_distinct = int(unique_u64(
            tree.compact(table.vals_sorted, missing_ok=True)).size)

    @property
    def _a2a(self) -> bool:
        return self.route == "a2a" and self.ndb > 1

    def _init_host(self, k, gaps, canonicalize, tree, capacity_factor,
                   emit_all, emit_kraken, emit_fastq, max_runs,
                   input_type=InputType.DNA):
        """The seed and the reads' alphabet, the host pipeline's state (as
        ``Classifier._setup``) and the taxonomy on each rank's device."""
        self._set_seed(k, gaps, canonicalize, input_type)
        self.tree = tree
        self.capacity_factor = float(capacity_factor)
        self.emit_all, self.emit_kraken = emit_all, emit_kraken
        self.emit_fastq = emit_fastq
        self.max_runs = int(max_runs)
        self._overflow_batches = 0
        self._overflow_bump_after = 3
        self.n_classified = 0
        self.n_unclassified = 0
        self.last_rounds = 0  # a2a rounds of the last step
        self._rank_images_used = False
        self.device = self.mesh.device(self.mesh.local_ranks[0])
        self._tax = {}
        for r in self.mesh.local_ranks:
            dev = self.mesh.device(r)
            if dev not in self._tax:
                self._tax[dev] = tree.device_arrays(dev)

    def _upload(self, arrays_of, rows: int = 0) -> None:
        """Each local rank's image on its device, ``arrays_of(s)`` giving
        (slots, vals, inline) of db index s (a row range of ``rows`` rows
        for the psum route), each (device, s) uploaded once."""
        self._arr: Dict[int, ProbeArrays] = {}
        done = {}
        inline = None
        for r in self.mesh.local_ranks:
            s = self.mesh.index(r, "db")
            dev = self.mesh.device(r)
            if (dev, s) not in done:
                slots, vals, inline = arrays_of(s)
                done[dev, s] = ProbeArrays.from_numpy(
                    slots, vals, inline, self.lgnb, self.vbits, dev,
                    s * rows, rows)
                if inline:
                    uvals = np.asarray(vals)
            self._arr[r] = done[dev, s]
        self._inline = bool(inline)
        # dictionary mode: the probe's value index (global across shards:
        # every shard encodes against one unique-values array) replaces the
        # 32-bit taxid in the compact output
        self._uniq_host = None
        if self._inline and uvals.size <= 0xFFFF:
            self._uniq_host = (uvals >> np.uint64(32)).astype(np.uint32)

    # -- rows of each rank -------------------------------------------------
    def _batch_multiple(self, paired: bool) -> int:
        ranks = self.ndp * self.ndb if self._a2a else self.ndp
        return ranks * 2 if paired else ranks

    def _sparse_n_ok(self) -> bool:
        """Never the sparse-N list: its flat positions are batch-global,
        and the ranks take blocks of the batch's rows (the JAX package's
        ShardedClassifier._sparse_n_ok)."""
        return False

    def _block(self, r: int) -> int:
        """The block of the batch's rows that rank r holds."""
        if self._a2a:
            return self.mesh.index(r, "dp") * self.ndb + self.mesh.index(r, "db")
        return self.mesh.index(r, "dp")

    def _writes(self, r: int) -> bool:
        """Whether rank r's rows belong to the output (the psum route's
        rows repeat over db: replica 0 writes them)."""
        return self._a2a or self.mesh.index(r, "db") == 0

    # -- the step of each rank ----------------------------------------------
    def _core(self, prep, paired: bool, compact: bool, maxr: int):
        """Every local rank's step on its block of the packed batch ->
        {rank: (taxon, oidx, hit, valid, valid1)} (compact=False) or
        {rank: (compact, full)}."""
        lproc = prep.lproc
        want_idx = compact and self._uniq_host is not None
        ups = self._uploads(prep)
        if self._a2a:
            out = self._a2a_probe(ups, lproc, want_idx)
        else:
            out = self._psum_probe(ups, lproc, want_idx)
        res = {}
        for r, (hit, valid, cidx, oidx) in out.items():
            valid1 = valid.sum(dim=-1, dtype=torch.int32)
            if paired:
                B, P = hit.shape
                hit = hit.view(B // 2, 2 * P)
                valid = valid.view(B // 2, 2 * P)
                cidx = cidx.view(B // 2, 2 * P)
                oidx = oidx.view(B // 2, 2 * P)
                valid1 = valid1[0::2].contiguous()
            if hit.shape[1]:
                taxon = resolve(cidx, hit, self._tax[hit.device],
                                self._n_distinct)
            else:  # no position (reads shorter than k): unclassified
                taxon = torch.zeros(hit.shape[0], dtype=torch.int32,
                                    device=hit.device)
            if compact:
                ds = None if self._uniq_host is None else len(self._uniq_host)
                res[r] = step_outputs(taxon, oidx, hit, valid, valid1, maxr, ds)
            else:
                res[r] = (taxon, oidx, hit, valid, valid1)
        return res

    def _uploads(self, prep):
        """Each local rank's block of the packed batch on its device ->
        {rank: (codes, nmask, lengths)}: the 2-bit words, or in the
        channel "codes" the int8 codes and no mask."""
        if prep.channel == "sparse":
            raise ValueError("the sharded classifier takes the N mask")
        pcodes, nmask, lengths = prep.pcodes, prep.nmask, prep.lengths
        bs = pcodes.shape[0] // self._batch_multiple(False)
        ups = {}
        for r in self.mesh.local_ranks:
            b, dev = self._block(r), self.mesh.device(r)
            sl = slice(b * bs, (b + 1) * bs)
            ups[r] = tuple(None if t is None else t[sl].to(dev, non_blocking=True)
                           for t in (pcodes, nmask, lengths))
        return ups

    def _a2a_probe(self, ups, lproc: int, want_idx: bool):
        """The a2a route: encode, then rounds of KD1 until no query is
        pending on any rank -> {rank: (hit, valid, cidx, oidx)}."""
        st, cap = self._a2a_start(ups, lproc)
        self.last_rounds = 0
        if cap:
            pending = self._total({r: (~s["done"]).sum() for r, s in st.items()})
            while pending:
                pending, _ = self._a2a_round(st, cap, want_idx)
                self.last_rounds += 1
        return {r: (s["hit"].view(s["shape"]), s["valid"],
                    s["cidx"].view(s["shape"]), s["oidx"].view(s["shape"]))
                for r, s in st.items()}

    def _a2a_start(self, ups, lproc: int):
        """Each rank's reads encoded (K1's encode-only) -> ({rank: the
        route's state: k-mers, validity, done, hit, cidx, oidx}, the
        queries an owner a rank takes in a round, 0 for no query)."""
        st = {}
        for r, (pc, nm, ln) in ups.items():
            if self.it != InputType.DNA:
                kmers, valid = encode_only_radix(pc, ln, self.k, False,
                                                 self.it, self.positions)
            else:
                kmers, valid = encode_only(pc, nm, ln, lproc, self.k,
                                           self.canon, self.positions)
            Q = kmers.numel()
            dev = kmers.device
            st[r] = dict(shape=kmers.shape, valid=valid, kq=kmers.view(-1),
                         done=~valid.view(-1),
                         hit=torch.zeros(Q, dtype=torch.bool, device=dev),
                         cidx=torch.zeros(Q, dtype=torch.int32, device=dev),
                         oidx=torch.zeros(Q, dtype=torch.int32, device=dev))
        Q = next(iter(st.values()))["kq"].numel()  # the same on every rank
        return st, (max(int(np.ceil(Q / self.ndb * self.capacity_factor)), 1)
                    if Q else 0)

    def _a2a_round(self, st, cap: int, want_idx: bool):
        """One round of the a2a route on every local rank: KD1's frame,
        the all_to_all, KD1's probe, the all_to_all back and KD1's
        collect, which updates each rank's state -> (the queries still
        pending on every rank, {"frame", "recv", "resp", "back", "left"}:
        each {rank: that launch's output})."""
        frame = {r: route_frame(s["kq"], s["done"], self.ndb, cap)
                 for r, s in st.items()}
        recv = self.mesh.all_to_all({r: f[0] for r, f in frame.items()})
        resp = {r: route_probe(recv[r], self._arr[r], want_idx) for r in st}
        back = self.mesh.all_to_all(resp)
        left = {r: route_collect(back[r], frame[r][1], s["done"], s["hit"],
                                 s["cidx"], s["oidx"])
                for r, s in st.items()}
        return self._total(left), dict(frame=frame, recv=recv, resp=resp,
                                       back=back, left=left)

    def _total(self, counts: Dict[int, torch.Tensor]) -> int:
        """The sum over every rank of each rank's count, read on the host
        once (the JAX while_loop's psum over ("dp", "db"))."""
        tot = self.mesh.psum({r: c.to(torch.int64) for r, c in counts.items()},
                             self.mesh.axis_names)
        return int(next(iter(tot.values())))

    def _psum_probe(self, ups, lproc: int, want_idx: bool):
        """The psum route: each rank probes its row range (K1's
        bucket-range instantiation), then one psum over db of (cidx, oidx,
        hit) -> {rank: (hit, valid, cidx, oidx)}."""
        part, valid = {}, {}
        for r, (pc, nm, ln) in ups.items():
            if self.it != InputType.DNA:
                hit, valid[r], cidx, oidx = encode_probe_radix(
                    pc, ln, self.k, False, self.it, self._arr[r], want_idx,
                    self.positions)
            else:
                hit, valid[r], cidx, oidx = encode_probe(
                    pc, nm, ln, lproc, self.k, self.canon, self._arr[r],
                    want_idx, self.positions)
            # each key lives on one rank: the sums are that rank's values
            part[r] = torch.stack([cidx, oidx, hit.to(torch.int32)])
        tot = self.mesh.psum(part, ("db",))
        return {r: (t[2] != 0, valid[r], t[0], t[1]) for r, t in tot.items()}

    # -- the raw step -----------------------------------------------------------
    def step(self, codes, lengths, paired: bool = False):
        """The JAX package's raw step on (B, L) int8 codes and (B,)
        lengths, B a multiple of the ranks (of 2 x the ranks when
        paired) -> numpy (taxon u32, taxa u32 (where hit), hit bool,
        n_missing int32, n_kmers int32, n_kmers1 int32), the rows of
        every rank in order (one process's ranks)."""
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        B, L = codes.shape
        mult = self._batch_multiple(paired)
        if B % mult:
            raise ValueError(f"{B} rows: a multiple of {mult} expected "
                             "(the ranks' share of a batch)")
        batch = fastx.ReadBatch(names=[b""] * B, seqs=[b""] * B, codes=codes,
                                lengths=lengths)
        prep = Classifier._prepare_batch(self, batch, paired, lproc=L)
        out = self._core(prep, paired, compact=False, maxr=self.max_runs)
        rows = []
        for r in sorted(out, key=self._block):
            if not self._writes(r):
                continue
            taxon, oidx, hit, valid, valid1 = out[r]
            rows.append((taxon, torch.where(hit, oidx, 0), hit,
                         (valid & ~hit).sum(-1, dtype=torch.int32),
                         valid.sum(-1, dtype=torch.int32), valid1))
        cols = [torch.cat([x[i].cpu() for x in rows]).numpy() for i in range(6)]
        cols[0] = cols[0].view(np.uint32)
        cols[1] = cols[1].view(np.uint32)
        return tuple(cols)

    # -- the host pipeline (Classifier.process_dataset runs these) -------------
    def _prepare_batch(self, batch: fastx.ReadBatch, paired: bool = False):
        """Pad the batch to a multiple of the ranks (an even row count a
        rank when paired) with empty rows, then pack it as the one-device
        classifier does."""
        n = len(batch.codes)
        mult = self._batch_multiple(paired)
        Bp = -(-max(n, 1) // mult) * mult
        if Bp != n:
            codes = np.full((Bp, batch.codes.shape[1]), -1, dtype=np.int8)
            codes[:n] = batch.codes
            lengths = np.zeros(Bp, dtype=np.int32)
            lengths[:n] = batch.lengths
            batch = fastx.ReadBatch(names=[], seqs=[], codes=codes,
                                    lengths=lengths)
        return Classifier._prepare_batch(self, batch, paired)

    def _dispatch_prepared(self, prep, paired: bool = False):
        """Every local rank's compact step, and the copies of the writing
        ranks' compact matrices, in rank order, to one host buffer."""
        if self.mesh.distributed and self.mesh.process_count > 1:
            raise RuntimeError("a mesh of several processes writes per-rank "
                               "output: process_dataset_distributed")
        maxr = self.max_runs
        out = self._core(prep, paired, compact=True, maxr=maxr)
        order = [r for r in sorted(out, key=self._block) if self._writes(r)]
        compacts = [out[r][0] for r in order]
        fulls = [out[r][1] for r in order]
        rows = sum(c.shape[0] for c in compacts)
        cols = compacts[0].shape[1]
        events = []
        if self.device.type == "cuda":
            host = torch.empty((rows, cols), dtype=torch.int32, pin_memory=True)
            at = 0
            for c in compacts:
                host[at:at + c.shape[0]].copy_(c, non_blocking=True)
                at += c.shape[0]
            for dev in {c.device for c in compacts}:
                with torch.cuda.device(dev):
                    ev = torch.cuda.Event()
                    ev.record()
                    events.append(ev)
        else:
            host = torch.cat(compacts)
        return host, events, fulls, prep.lproc, maxr

    def _dispatch_batch(self, batch: fastx.ReadBatch, paired: bool = False):
        return self._dispatch_prepared(self._prepare_batch(batch, paired),
                                       paired)

    def _finish_batch(self, batch: fastx.ReadBatch, out, paired: bool = False,
                      force_full: bool = False):
        compact, events, fulls, lproc, maxr = out
        with span("device_wait", self.span_seconds):
            for ev in events:
                ev.synchronize()
        R = len(batch.names) // 2 if paired else len(batch.names)
        cm = compact.numpy().view(np.uint32)[:R]
        return self._finish_arrays(
            batch, cm,
            lambda: torch.cat([f.cpu() for f in fulls]).numpy().view(
                np.uint32)[:R],
            lproc, maxr, paired, force_full)

    # -- per-rank output --------------------------------------------------------
    def process_dataset_distributed(self, path: str, out_dir: str,
                                    mate_path: Optional[str] = None,
                                    batch_size: int = 4096) -> int:
        """Classify with per-process output: every process reads the whole
        input and runs the same steps (the collectives span the mesh), and
        writes only the rows of its own ranks (the psum route's replica 0)
        to ``part-{pid:05d}.tsv``, with a ``.idx`` of each batch's pieces
        (row start, bytes); ``merge_distributed_output`` gives back the
        one-process stream.  max_runs is never raised here (every process
        must run the same step); a run overflow takes the rank's full
        matrix.  Returns the rows this process wrote."""
        pid, nproc = self.mesh.process_index, self.mesh.process_count
        os.makedirs(out_dir, exist_ok=True)
        part = os.path.join(out_dir, f"part-{pid:05d}.tsv")
        idx = []
        is_paired = mate_path is not None
        if is_paired and batch_size % 2:
            batch_size += 1
        written = 0
        with open(part, "w", encoding="utf-8") as fh:
            for batch in fastx.batch_reads(path, self.lut,
                                           batch_size=batch_size,
                                           mate_path=mate_path):
                prep = self._prepare_batch(batch, is_paired)
                maxr = self.max_runs
                out = self._core(prep, is_paired, compact=True, maxr=maxr)
                n = len(batch.names)
                R = n // 2 if is_paired else n
                per = prep.pcodes.shape[0] // self._batch_multiple(False)
                per = per // 2 if is_paired else per
                pieces = []
                for r in sorted(out, key=self._block):
                    if not self._writes(r):
                        continue
                    r0 = self._block(r) * per
                    r1 = min(r0 + per, R)
                    if r1 <= r0:
                        continue
                    cm_t, full_t = out[r]
                    cm = cm_t.cpu().numpy().view(np.uint32)[: r1 - r0]
                    sub = _slice_batch(batch, r0, r1, is_paired)
                    res = self._finish_arrays(
                        sub, cm,
                        lambda f=full_t, m=r1 - r0: f[:m].cpu().numpy().view(
                            np.uint32),
                        prep.lproc, maxr, is_paired, allow_bump=False)
                    text = out_mod.format_batch(
                        res, self.sp.c, emit_all=self.emit_all,
                        emit_kraken=self.emit_kraken,
                        emit_fastq=self.emit_fastq)
                    fh.write(text)
                    pieces.append([int(r0), len(text.encode("utf-8"))])
                    written += r1 - r0
                idx.append(pieces)
        with open(part + ".idx", "w") as fh:
            json.dump(dict(pid=pid, nproc=nproc, batches=idx), fh)
        return written

    # -- the a2a route's gather volume ---------------------------------------
    def gather_rows_per_step(self, n_reads: int, read_len: int,
                             rounds: int = 1) -> int:
        """Slot-row gathers a rank makes in one step over n_reads reads of
        read_len bases (``gather_rows_per_step`` of the JAX package): flat
        in ndb on the a2a route, ndb-fold on the psum route."""
        P = max(read_len - self.sp.c + 1, 0)
        if self._a2a:
            q_local = -(-n_reads // (self.ndp * self.ndb)) * P
            cap = max(int(np.ceil(q_local / self.ndb * self.capacity_factor)),
                      1)
            return 2 * self.ndb * cap * rounds
        return 2 * (-(-n_reads // self.ndp)) * P

    # -- from a sharded directory ---------------------------------------------
    @classmethod
    def from_sharded_dir(cls, dirpath: str, tree, mesh: Mesh,
                         canonicalize: bool = True,
                         input_type: InputType = InputType.DNA,
                         capacity_factor: float = 1.05,
                         emit_all: bool = False, emit_kraken: bool = True,
                         emit_fastq: bool = False, max_runs: int = 8):
        """A classifier over a ``build --shards N`` directory that loads
        only its local ranks' shard files: a group of N / ndb consecutive
        files a rank where ndb divides N, one file a rank where N = ndb
        (the a2a route's partition is the files' own), from per-rank
        images (``bake_rank_images``) whose fingerprint matches; any other
        split, or a mesh of one db rank, merge-loads the directory."""
        with open(os.path.join(dirpath, "manifest.json")) as fh:
            mf = json.load(fh)
        ndb = mesh.shape.get("db", 1)
        mfndb = mf["ndb"]
        if ndb >= 2 and mfndb > ndb and mfndb % ndb == 0:
            group = mfndb // ndb
        elif mfndb != ndb or ndb < 2:
            return cls(formats.load_database_sharded(dirpath), tree, mesh,
                       canonicalize, input_type,
                       capacity_factor=capacity_factor,
                       emit_all=emit_all, emit_kraken=emit_kraken,
                       emit_fastq=emit_fastq, max_runs=max_runs)
        else:
            group = 1
        if tree.tin.size >= 1 << 31:
            raise ValueError("taxonomy too large for the 31-bit compact "
                             "index in the a2a response word")
        self = cls.__new__(cls)
        self.mesh, self.ndb = mesh, ndb
        self.ndp = mesh.shape.get("dp", 1)
        self.route = "a2a"
        self._init_host(mf["k"], mf["gaps"], canonicalize, tree,
                        capacity_factor, emit_all, emit_kraken, emit_fastq,
                        max_runs, input_type)
        geo = _geometry(dirpath, mf, ndb, tree)
        self.lgnb, self.vbits = geo["lgnb"], geo["vbits"]
        img_dir = _image_dir(dirpath, ndb, tree)
        self._rank_images_used = _images_match(img_dir, geo,
                                               fingerprint(dirpath, mf))
        needed = sorted({mesh.index(r, "db") for r in mesh.local_ranks})
        if self._rank_images_used:
            def load(s):
                slots = np.load(os.path.join(img_dir, f"slots-{s:05d}.npy"),
                                mmap_mode="r")
                if geo["uniq_packed"] is not None:
                    return slots, geo["uniq_packed"], True
                return slots, np.load(os.path.join(img_dir,
                                                   f"vals-{s:05d}.npy"),
                                      mmap_mode="r"), False
            arrays = {s: load(s) for s in needed}
        else:
            # the heavy parts (file read, sort, placement) release the GIL
            with concurrent.futures.ThreadPoolExecutor(
                    min(4, max(len(needed), 1))) as pool:
                got = pool.map(lambda s: _rank_arrays(dirpath, mf, s, group,
                                                      geo, tree), needed)
                arrays = dict(zip(needed, got))
        self._upload(lambda s: arrays[s])
        u32v = geo["u32v"]
        self._n_distinct = (None if u32v is None else int(unique_u64(
            tree.compact(u32v, missing_ok=True)).size))
        return self


def _slice_batch(batch: fastx.ReadBatch, r0: int, r1: int, paired: bool):
    """Output rows [r0, r1) of a batch (pairs of rows when paired)."""
    a, b = (2 * r0, 2 * r1) if paired else (r0, r1)
    return fastx.ReadBatch(
        names=batch.names[a:b], seqs=batch.seqs[a:b], codes=batch.codes[a:b],
        lengths=batch.lengths[a:b],
        quals=batch.quals[a:b] if batch.quals else None)


# -- sharded directories: geometry, rank arrays, images -------------------------

def _geometry(dirpath: str, mf: dict, ndb: int, tree) -> dict:
    """The common geometry of a directory's ranks at ``ndb`` ranks: the
    bucket count (the manifest's, or from the largest group's keys), and
    the global dictionary (``uniq_vals.npy``) where it fits the slot's
    index field."""
    mfndb = mf["ndb"]
    group = mfndb // ndb
    if group > 1:
        sums = [sum(mf["shard_n"][r * group:(r + 1) * group])
                for r in range(ndb)]
        nmax = max(max(sums), 1)
        nb = max(_next_pow2(int(np.ceil(nmax / (SLOTS * MAX_LOAD)))), 4)
    elif "nb" in mf:
        nb = int(mf["nb"])
    else:
        nmax = max(max(mf["shard_n"]), 1)
        nb = max(_next_pow2(int(np.ceil(nmax / (SLOTS * MAX_LOAD)))), 4)
    lgnb = int(nb).bit_length() - 1
    vbits = max(lgnb - 2, 0)
    uniq_packed = u32v = None
    uf = mf.get("uniq_vals")
    if uf and os.path.exists(os.path.join(dirpath, uf)):
        uv = np.load(os.path.join(dirpath, uf))
        if uv.size and int(uv.max()) <= 0xFFFFFFFF and uv.size <= 1 << vbits:
            u32v = uv.astype(np.uint32)
            uniq_packed = formats.payload(u32v, tree)
    return dict(nb=nb, lgnb=lgnb, vbits=vbits, group=group,
                uniq_packed=uniq_packed, u32v=u32v)


def _rank_arrays(dirpath: str, mf: dict, s: int, group: int, geo: dict, tree):
    """(slots, vals, inline) of rank s: its group of shard files merged,
    placed at the common bucket count and encoded against the global
    dictionary (inline), or flat where the directory records none."""
    ks, vs = [], []
    for f in range(s * group, (s + 1) * group):
        got = formats.read_database_arrays(os.path.join(dirpath,
                                                        mf["shards"][f]))
        if got is None:
            raise ValueError(f"{mf['shards'][f]}: not a BTPU1 shard file")
        ks.append(got[1])
        vs.append(got[2])
    if group == 1:
        keys, vals = ks[0], vs[0]
    else:  # files within a group interleave in key order
        keys, vals = np.concatenate(ks), np.concatenate(vs)
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
    tbl = KmerTable(keys, vals, min_nb=geo["nb"])
    if tbl.nb != geo["nb"]:
        raise RuntimeError(f"shard {s} required bucket growth ({tbl.nb} != "
                           f"{geo['nb']}); rebuild the sharded DB with more "
                           "shards")
    packed = formats.payload(vals, tree)
    if geo["uniq_packed"] is not None:
        return tbl.encode_slots(packed, uniq=geo["uniq_packed"])
    return tbl.encode_slots(packed, allow_inline=False)


def _image_dir(dirpath: str, ndb: int, tree) -> str:
    return os.path.join(dirpath,
                        f"rankimg-db{ndb}-{formats.tree_digest(tree)}")


def fingerprint(dirpath: str, mf: dict) -> str:
    """The fingerprint of a sharded directory's content that a rank image
    was baked from: the manifest's sha256, and the size and mtime (ns) of
    each shard file and of the dictionary file.  A shard rebuilt in place
    changes its mtime, so its images no longer match."""
    h = hashlib.sha256()
    with open(os.path.join(dirpath, "manifest.json"), "rb") as fh:
        h.update(hashlib.sha256(fh.read()).digest())
    for name in list(mf["shards"]) + [mf.get("uniq_vals") or ""]:
        p = os.path.join(dirpath, name)
        if name and os.path.exists(p):
            st = os.stat(p)
            h.update(f"{name}\0{st.st_size}\0{st.st_mtime_ns}\n".encode())
    return h.hexdigest()


def _images_match(img_dir: str, geo: dict, fp: str) -> bool:
    meta_p = os.path.join(img_dir, "meta.json")
    if not os.path.exists(meta_p):
        return False
    with open(meta_p) as fh:
        im = json.load(fh)
    return (im.get("nb") == geo["nb"]
            and im.get("inline") == (geo["uniq_packed"] is not None)
            and im.get("fingerprint") == fp)


def bake_rank_images(dirpath: str, tree, db_ranks: int = 0) -> str:
    """Per-rank classify-ready images of a sharded directory for a mesh of
    ``db_ranks`` db ranks (default: one a shard file): each rank's slot
    words (and flat values) saved mmap-loadable under
    ``dirpath/rankimg-db{N}-{tree digest}/``, with the fingerprint of the
    shard files in ``meta.json``; ``from_sharded_dir`` then loads them
    with no sort or placement.  The ``.npy`` files are the JAX package's."""
    with open(os.path.join(dirpath, "manifest.json")) as fh:
        mf = json.load(fh)
    mfndb = mf["ndb"]
    ndb = db_ranks or mfndb
    if mfndb % ndb or mfndb < ndb:
        raise ValueError(f"db_ranks {ndb} must divide shard count {mfndb}")
    fp = fingerprint(dirpath, mf)
    geo = _geometry(dirpath, mf, ndb, tree)
    img_dir = _image_dir(dirpath, ndb, tree)
    os.makedirs(img_dir, exist_ok=True)
    meta_p = os.path.join(img_dir, "meta.json")
    if os.path.exists(meta_p):
        os.unlink(meta_p)  # no loader takes a half-written image
    for s in range(ndb):
        slots, vals, inline = _rank_arrays(dirpath, mf, s, geo["group"], geo,
                                           tree)
        np.save(os.path.join(img_dir, f"slots-{s:05d}.npy"), slots)
        if not inline:
            np.save(os.path.join(img_dir, f"vals-{s:05d}.npy"),
                    np.asarray(vals))
    with open(meta_p, "w") as fh:
        json.dump(dict(format="btpu-rank-images", version=1, ndb=ndb,
                       nb=geo["nb"], inline=geo["uniq_packed"] is not None,
                       tree_digest=formats.tree_digest(tree),
                       fingerprint=fp), fh)
    return img_dir


# -- per-rank output --------------------------------------------------------------

def merge_distributed_output(out_dir: str, out_fh) -> int:
    """The one-process byte stream from the part files of
    ``process_dataset_distributed``: each batch's pieces from every rank
    in row order.  Part files that do not form one run (ranks 0..n-1 of
    one process count) raise.  Returns the bytes written."""
    parts = sorted(glob.glob(os.path.join(out_dir, "part-*.tsv")))
    idxs, pids, nprocs = [], [], set()
    for p in parts:
        with open(p + ".idx") as fh:
            meta = json.load(fh)
        idxs.append(meta["batches"])
        pids.append(meta.get("pid"))
        nprocs.add(meta.get("nproc"))
    if parts:
        want_n = nprocs.pop() if len(nprocs) == 1 else None
        known = sorted(p for p in pids if p is not None)
        if want_n is None or len(known) != len(pids) or known != list(
                range(want_n)):
            raise ValueError(
                f"{out_dir}: part files for ranks {pids} do not form one "
                f"complete run (expected ranks 0..{want_n}) — stale files "
                "from a previous run? remove the directory and re-run")
    fhs = [open(p, "rb") for p in parts]
    try:
        total = 0
        for b in range(max((len(i) for i in idxs), default=0)):
            pieces = sorted((r0, rank, nb) for rank, ix in enumerate(idxs)
                            if b < len(ix) for r0, nb in ix[b])
            # each rank's file holds its pieces in this same order
            for r0, rank, nb in pieces:
                out_fh.write(fhs[rank].read(nb).decode("utf-8"))
                total += nb
        return total
    finally:
        for fh in fhs:
            fh.close()


# -- the sequence-parallel encode ---------------------------------------------------

def sharded_encode_contig(codes: torch.Tensor, k: int, mesh: Mesh,
                          canonical: bool = True):
    """A contig's k-mers with its (1, L) codes split along ``sp``: each
    rank encodes its block and a (k - 1)-code halo from its right
    neighbour (``ppermute``; the last rank's halo is invalid) with KB1 at
    W = 1, 0 where no k-mer is valid -> (kmers int64, valid bool) of each
    position, (1, L), the ranks' blocks in order.  L must be a multiple
    of the ranks, as under ``shard_map``."""
    nsp = mesh.shape["sp"]
    L = codes.shape[-1]
    if L % nsp:
        raise ValueError(f"contig of {L} codes does not split into {nsp} "
                         "equal blocks")
    blk = L // nsp
    halo = k - 1
    if halo > blk:
        raise ValueError(f"halo of {halo} codes exceeds the block of {blk}")
    mine = {r: codes[:, mesh.index(r, "sp") * blk:
                     (mesh.index(r, "sp") + 1) * blk].to(mesh.device(r))
            for r in mesh.local_ranks}
    # every rank sends its first k - 1 codes to its left neighbour; the
    # last rank's wraps round and is marked invalid
    recv = mesh.ppermute({r: c[:, :halo].contiguous() for r, c in mine.items()},
                         [(i, (i - 1) % nsp) for i in range(nsp)], "sp")
    out = {}
    for r, c in mine.items():
        h = recv[r]
        if mesh.index(r, "sp") == nsp - 1:
            h = torch.full_like(h, -1)
        ext = torch.cat([c, h], dim=1).contiguous()
        ln = torch.tensor([ext.shape[1]], dtype=torch.int32, device=c.device)
        em = minimizers(ext, ln, k, 1, canonical, zero_invalid=True)
        out[r] = (em.values, em.mask)
    order = sorted(out, key=lambda r: mesh.index(r, "sp"))
    return (torch.cat([out[r][0] for r in order], dim=1),
            torch.cat([out[r][1] for r in order], dim=1))
