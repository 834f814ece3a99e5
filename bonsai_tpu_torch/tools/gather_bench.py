"""Row-gather microbenchmarks of the probe on one CUDA card.

Ports the JAX package's two Pallas experiments as hand-written CUDA
kernels (``csrc/gather_bench.cu``), each with its plain torch version:

* G1 ``row_gather``: ``out[i] = tbl[idx[i]]`` at ``tools/probe_microbench.py``
  variant F's shape (2^19 indices into 2^21 rows of 32 u32 = 128 B, a
  256 MiB table), and, for the question whether random row reads slow
  down past some table size, at the probe's 32-B rows over tables from
  16 MiB (inside the 50 MB L2) to 4 GiB;
* G2 ``take_along``: ``take_along_axis`` of a u32 table on axis 0 or 1 at
  the four shapes of ``tools/vmem_gather_bench2.py``.

Every case is held against its plain version on the same tensors (exact
equality) and timed beside it.  G1 is timed with CUDA events around
back-to-back calls.  A G2 call takes a few microseconds on the card, less
than the host takes to enqueue it, so G2 and its plain version are timed
by replaying a CUDA graph of ``GRAPH_CALLS`` captured calls between two
events (``graph_ms``), with the event timing of back-to-back calls beside
it.  An index outside the table stops either kernel with a trap, as
``torch.gather``'s device-side assert does: the CUDA context is lost and
the next synchronising call raises.

    python -m bonsai_tpu_torch.tools.gather_bench

It prints one line per case and then the results as one JSON object.
It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import json
import sys
from functools import partial

import torch

from .. import kernels

F_ROWS, F_QUERIES, F_LANES = 1 << 21, 1 << 19, 32
CLIFF_MIB = (16, 128, 1024, 4096)
CLIFF_QUERIES = 1 << 22
GRAPH_CALLS = 100


def row_gather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch G1: rows of ``tbl`` (R, C) at ``idx`` (Q,) -> (Q, C)."""
    return tbl[idx.to(torch.int64)]


def row_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G1 (``csrc/gather_bench.cu`` ``bk_row_gather``): see
    ``row_gather_plain``, which serves CPU tensors.  tbl (R, C) int32
    holding u32 with C a multiple of 4 (16-B vectors), idx (Q,) int32."""
    if tbl.device.type == "cpu":
        return row_gather_plain(tbl, idx)
    if tbl.device.type != "cuda":
        raise ValueError(f"row_gather: no kernel for device {tbl.device}")
    dev = tbl.device
    if tbl.dim() != 2 or tbl.shape[1] % 4:
        raise ValueError(f"tbl: shape {tuple(tbl.shape)}, need (R, 4m)")
    kernels.check(tbl, "tbl", torch.int32, dev)
    if idx.dim() != 1:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, need (Q,)")
    kernels.check(idx, "idx", torch.int32, dev)
    (R, C), Q = tbl.shape, idx.shape[0]
    out = torch.empty((Q, C), dtype=torch.int32, device=dev)
    if Q and C:
        kernels.launch("bk_row_gather", dev, tbl.data_ptr(), idx.data_ptr(),
                       R, Q, C, out.data_ptr())
        row_gather.launches += 1
    return out


row_gather.launches = 0


def take_along_plain(tab: torch.Tensor, idx: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Plain torch G2: ``take_along_axis(tab, idx, axis)`` for 2-D
    tensors (axis 0: out[i, j] = tab[idx[i, j], j]; axis 1: out[i, j] =
    tab[i, idx[i, j]])."""
    return torch.gather(tab, axis, idx.to(torch.int64))


def take_along(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """G2 (``csrc/gather_bench.cu`` ``bk_take_along``): see
    ``take_along_plain``, which serves CPU tensors.  tab (R, Ct) int32
    holding u32, idx (Q, Ci) int32; axis 0 needs Ci == Ct, axis 1 Q == R."""
    if tab.device.type == "cpu":
        return take_along_plain(tab, idx, axis)
    if tab.device.type != "cuda":
        raise ValueError(f"take_along: no kernel for device {tab.device}")
    dev = tab.device
    if tab.dim() != 2 or idx.dim() != 2:
        raise ValueError("take_along: tab and idx must be 2-D")
    kernels.check(tab, "tab", torch.int32, dev)
    kernels.check(idx, "idx", torch.int32, dev)
    (R, Ct), (Q, Ci) = tab.shape, idx.shape
    if axis == 0 and Ci != Ct or axis == 1 and Q != R or axis not in (0, 1):
        raise ValueError(f"take_along: idx {tuple(idx.shape)} does not fit "
                         f"tab {tuple(tab.shape)} on axis {axis}")
    out = torch.empty((Q, Ci), dtype=torch.int32, device=dev)
    if Q and Ci:
        kernels.launch("bk_take_along", dev, tab.data_ptr(), idx.data_ptr(),
                       R, Ct, Q, Ci, axis, out.data_ptr())
        take_along.launches += 1
    return out


take_along.launches = 0


def empty_launch(blocks: int, coop: bool, device) -> None:
    """A yardstick, no kernel of a path (``csrc/gather_bench.cu``
    ``bk_empty_launch``): an empty launch of ``blocks`` blocks of 256
    threads, or with ``coop`` a cooperative one whose blocks meet at one
    grid barrier.  Timed by ``graph_ms``, the floor of such a launch."""
    kernels.launch("bk_empty_launch", torch.device(device), blocks, int(coop))


def f_case(device, seed: int = 0):
    """Variant F's inputs: a (2^21, 32) u32 table and 2^19 random rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    tbl = torch.randint(0, 1 << 31, (F_ROWS, F_LANES), generator=g,
                        dtype=torch.int32, device=device)
    idx = torch.randint(0, F_ROWS, (F_QUERIES,), generator=g,
                        dtype=torch.int32, device=device)
    return tbl, idx


def take_cases(device):
    """The four ``build_*`` cases of vmem_gather_bench2.py: (name, tab, idx,
    axis)."""
    def ar(n):
        return torch.arange(n, dtype=torch.int32, device=device)

    out = []
    R, C = 1024, 128
    tab = ar(R * C).reshape(R, C)
    out.append(("same-shape axis0 512KB", tab, (ar(R * C) % R).reshape(R, C), 0))
    out.append(("same-shape axis1 512KB", tab, (ar(R * C) % C).reshape(R, C), 1))
    R, Q = 8192, 4096
    tab = ar(R * C).reshape(R, C)
    out.append(("diff-rows axis0", tab, (ar(Q * C) % R).reshape(Q, C), 0))
    out.append(("same-shape axis0 4MB", tab,
                (ar(R * C) * 7 % R).reshape(R, C), 0))
    return out


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device milliseconds of fn() by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, calls: int = GRAPH_CALLS) -> float:
    """Mean device milliseconds of fn() by CUDA-graph replay: ``calls``
    calls captured once, the graph replayed between two events, so that
    no host work sits between the launches."""
    fn()  # first use outside the capture: loads the kernel library
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def _pair(kern, plain, timer=time_ms):
    """(kernel ms, plain ms), each the mean of two runs in the order
    plain, kernel, kernel, plain."""
    p1 = timer(plain)
    k1 = timer(kern)
    k2 = timer(kern)
    p2 = timer(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _same(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: the kernel differs from its plain version")


def run(device, seed: int = 0, say=print) -> dict:
    """Check and time every case on ``device`` (a CUDA device)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("gather_bench measures a CUDA card")
    res = {"row_gather": {}, "take_along": {}, "cliff": []}
    tbl, idx = f_case(dev, seed)
    _same(row_gather(tbl, idx), row_gather_plain(tbl, idx), "G1 variant F")
    k, p = _pair(lambda: row_gather(tbl, idx), lambda: row_gather_plain(tbl, idx))
    useful = F_QUERIES * F_LANES * 4
    res["row_gather"] = {"ms": k, "plain_ms": p, "useful_GBps": useful / k / 1e6,
                         "plain_useful_GBps": useful / p / 1e6}
    say(f"# G1 row_gather, variant F: {F_QUERIES} rows of 128 B from a "
        f"{F_ROWS * 128 / 2**20:.0f} MiB table: kernel {k:.4f} ms "
        f"({useful / k / 1e6:.1f} GB/s useful), plain {p:.4f} ms "
        f"({useful / p / 1e6:.1f} GB/s)")
    del tbl
    for name, tab, ix, axis in take_cases(dev):
        _same(take_along(tab, ix, axis), take_along_plain(tab, ix, axis),
              f"G2 {name}")
        kern = partial(take_along, tab, ix, axis)
        plain = partial(take_along_plain, tab, ix, axis)
        k, p = _pair(kern, plain, graph_ms)
        ke, pe = _pair(kern, plain)
        nq = ix.numel()
        res["take_along"][name] = {"ms": k, "plain_ms": p,
                                   "ns_per_query": k * 1e6 / nq,
                                   "plain_ns_per_query": p * 1e6 / nq,
                                   "event_ms": ke, "plain_event_ms": pe}
        say(f"# G2 take_along {name} ({tuple(tab.shape)} table, idx "
            f"{tuple(ix.shape)}), graph replay of {GRAPH_CALLS} calls: "
            f"kernel {k * 1e3:.3f} us ({k * 1e6 / nq:.4f} ns/query), plain "
            f"{p * 1e3:.3f} us ({p * 1e6 / nq:.4f} ns/query); events around "
            f"back-to-back calls: kernel {ke:.4f} ms, plain {pe:.4f} ms")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for mib in CLIFF_MIB:
        rows = mib * 2**20 // 32
        tbl = torch.randint(0, 1 << 31, (rows, 8), generator=g,
                            dtype=torch.int32, device=dev)
        idx = torch.randint(0, rows, (CLIFF_QUERIES,), generator=g,
                            dtype=torch.int32, device=dev)
        _same(row_gather(tbl, idx), row_gather_plain(tbl, idx),
              f"G1 32-B rows, {mib} MiB")
        k = time_ms(lambda: row_gather(tbl, idx))
        ns = k * 1e6 / CLIFF_QUERIES
        res["cliff"].append({"table_MiB": mib, "ms": k, "ns_per_row": ns,
                             "useful_GBps": CLIFF_QUERIES * 32 / k / 1e6})
        say(f"# G1 cliff: {CLIFF_QUERIES} random 32-B rows from a {mib} MiB "
            f"table: {k:.4f} ms = {ns:.4f} ns/row "
            f"({CLIFF_QUERIES * 32 / k / 1e6:.1f} GB/s useful)")
        del tbl, idx
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_bench: no CUDA device", file=sys.stderr)
        return 2
    print(f"# device: {torch.cuda.get_device_name(0)}")
    print(json.dumps(run(torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
