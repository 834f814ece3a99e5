"""KD1: one round of the a2a route's routed probe, in three launches.

Counterpart of ``_build_fn_a2a.routed_probe`` of
``bonsai_tpu/parallel/sharded.py`` (:288-399), cut where the mesh's two
``all_to_all`` exchanges sit (``parallel/sharded.py`` runs the loop):

  ``route_frame``    pending queries -> an (ndb, cap) send frame: owner
                     o's r-th pending query in index order goes to row
                     o * cap + r while r < cap, the rest wait for a later
                     round; ``slotq`` says where each query went
  ``route_probe``    a received frame probed against the rank's sub-table
                     -> response words
  ``route_collect``  the returned responses into the queries' done, hit,
                     cidx and oidx; the count of queries still pending

Each is a wrapper of ``csrc/route.cu`` with its plain torch version
beside it; the plain versions serve CPU tensors only.  Queries are
int64-held u64 keys; ``dump = ndb * cap`` is the row of a query that
goes nowhere this round, and unused frame rows hold U64_MAX (int64 -1).
A response word is (orig taxid | found << 31 | compact index), or with
``want_idx`` (dictionary mode) (value index << 32 | found << 31 |
compact index); 0 where the key is missing.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core.bitops import i64
from ..db.table import ProbeArrays, probe_slots, shard_owner_plain

MAX_OWNERS = 1024  # the frame kernel's owners (a block's shared counts)
LOW31 = 0x7FFFFFFF
HIGH32 = i64(0xFFFFFFFF00000000)


# -- route_frame -----------------------------------------------------------------

def route_frame_plain(kq: torch.Tensor, done: torch.Tensor, ndb: int,
                      cap: int):
    """Plain torch ``route_frame``: (send (ndb * cap,) int64, slotq (Q,)
    int32).  The JAX function sorts (owner << 32 | index) with SENT =
    U64_MAX for the done queries; here the key is owner * Q + index, and
    ndb * Q stands for SENT, which orders the same."""
    Q = kq.numel()
    dev = kq.device
    dump = ndb * cap
    iota = torch.arange(Q, device=dev)
    owner = shard_owner_plain(kq, ndb).to(torch.int64)
    key = torch.where(done, ndb * Q, owner * Q + iota)
    skey, order = torch.sort(key)
    sowner = torch.div(skey, max(Q, 1), rounding_mode="floor")
    seg = torch.searchsorted(sowner, torch.arange(ndb + 1, device=dev))
    r = iota - seg[sowner]
    ok = (sowner < ndb) & (r < cap)
    row = torch.where(ok, sowner * cap + r, dump)
    slotq = torch.empty(Q, dtype=torch.int32, device=dev)
    slotq[order] = row.to(torch.int32)
    send = torch.full((dump + 1,), -1, dtype=torch.int64, device=dev)
    send.scatter_(0, row, kq[order])  # rows past the frame land on dump
    return send[:dump], slotq


def route_frame(kq: torch.Tensor, done: torch.Tensor, ndb: int, cap: int):
    """KD1 frame (``csrc/route.cu`` ``bk_route_frame``): see
    ``route_frame_plain``, which serves CPU tensors.  kq (Q,) int64, done
    (Q,) bool; 1 <= ndb <= 1024, Q < 2^30, ndb * cap < 2^31."""
    if not 1 <= ndb <= MAX_OWNERS:
        raise ValueError(f"ndb={ndb}: the frame takes 1..{MAX_OWNERS} owners")
    if cap < 1 or ndb * cap >= 1 << 31:
        raise ValueError(f"cap={cap}: the frame takes 1 <= ndb * cap < 2^31")
    if kq.device.type == "cpu":
        return route_frame_plain(kq, done, ndb, cap)
    if kq.device.type != "cuda":
        raise ValueError(f"route_frame: no kernel for device {kq.device}")
    dev = kq.device
    Q = kq.numel()
    if Q >= 1 << 30:
        raise ValueError(f"route_frame: {Q} queries, the kernel takes < 2^30")
    kernels.check(kq, "kq", torch.int64, dev, (Q,))
    kernels.check(done, "done", torch.bool, dev, (Q,))
    send = torch.empty(ndb * cap, dtype=torch.int64, device=dev)
    slotq = torch.empty(Q, dtype=torch.int32, device=dev)
    scratch = kernels.scratch("bk_route_frame", (Q, ndb), dev)
    kernels.launch("bk_route_frame", dev, kq.data_ptr(), done.data_ptr(), Q,
                   ndb, cap, send.data_ptr(), slotq.data_ptr(),
                   scratch.data_ptr())
    route_frame.launches += 1
    return send, slotq


route_frame.launches = 0


# -- route_probe -------------------------------------------------------------------

def route_probe_plain(recv: torch.Tensor, arr: ProbeArrays,
                      want_idx: bool) -> torch.Tensor:
    """Plain torch ``route_probe``: (n,) received keys -> (n,) int64
    response words."""
    val, found, sel = probe_slots(recv, arr, want_idx=True)
    high = (sel << 32) if want_idx else (val & HIGH32)
    return torch.where(found, high | (1 << 31) | (val & LOW31), 0)


def route_probe(recv: torch.Tensor, arr: ProbeArrays,
                want_idx: bool) -> torch.Tensor:
    """KD1 probe (``csrc/route.cu`` ``bk_route_probe``: both candidate
    rows of a key loaded at once, compared as ``csrc/probe.cuh`` probes):
    see ``route_probe_plain``, which serves CPU tensors.  recv (n,) int64
    against a whole sub-table's image."""
    if recv.device.type == "cpu":
        return route_probe_plain(recv, arr, want_idx)
    if recv.device.type != "cuda":
        raise ValueError(f"route_probe: no kernel for device {recv.device}")
    dev = recv.device
    n = recv.numel()
    kernels.check(recv, "recv", torch.int64, dev, (n,))
    arr.check(dev)
    resp = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        kernels.launch("bk_route_probe", dev, recv.data_ptr(), n, *arr.args(),
                       int(want_idx), resp.data_ptr())
        route_probe.launches += 1
    return resp


route_probe.launches = 0


# -- route_collect -------------------------------------------------------------------

def route_collect_plain(back, slotq, done, hit, cidx, oidx) -> torch.Tensor:
    """Plain torch ``route_collect``: updates done, hit, cidx, oidx in
    place where slotq < dump = back.numel(); returns the count of queries
    not done (a 0-d int64 tensor)."""
    dump = back.numel()
    newly = slotq.to(torch.int64) < dump
    got = back[slotq.to(torch.int64).clamp(max=dump - 1)]
    done |= newly
    hit.copy_(torch.where(newly, ((got >> 31) & 1) != 0, hit))
    cidx.copy_(torch.where(newly, (got & LOW31).to(torch.int32), cidx))
    hi = (got >> 32) & 0xFFFFFFFF
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi).to(torch.int32)
    oidx.copy_(torch.where(newly, hi, oidx))
    return (~done).sum()


def route_collect(back, slotq, done, hit, cidx, oidx) -> torch.Tensor:
    """KD1 collect (``csrc/route.cu`` ``bk_route_collect``): see
    ``route_collect_plain``, which serves CPU tensors.  back (dump,)
    int64, slotq (Q,) int32; done, hit (Q,) bool and cidx, oidx (Q,)
    int32 updated in place (views at any offset); the pending count
    stays on the card.  One launch, no memset: the blocks add their counts
    to a tally on the card, whose last block writes the pending word."""
    if back.device.type == "cpu":
        return route_collect_plain(back, slotq, done, hit, cidx, oidx)
    if back.device.type != "cuda":
        raise ValueError(f"route_collect: no kernel for device {back.device}")
    dev = back.device
    Q = slotq.numel()
    kernels.check(back, "back", torch.int64, dev)
    kernels.check(slotq, "slotq", torch.int32, dev, (Q,))
    for t, name, dt in ((done, "done", torch.bool), (hit, "hit", torch.bool),
                        (cidx, "cidx", torch.int32),
                        (oidx, "oidx", torch.int32)):
        kernels.check(t, name, dt, dev, (Q,))
    pending = torch.empty((), dtype=torch.int64, device=dev)
    kernels.launch("bk_route_collect", dev, back.data_ptr(), slotq.data_ptr(),
                   Q, back.numel(), done.data_ptr(), hit.data_ptr(),
                   cidx.data_ptr(), oidx.data_ptr(), pending.data_ptr())
    route_collect.launches += 1
    return pending


route_collect.launches = 0
