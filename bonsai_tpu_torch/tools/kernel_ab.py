"""Time the build kernels of an earlier revision against the current ones.

Compiles ``merge_fold.cu`` and ``minimizers.cu`` from a directory that
holds an earlier revision's ``bonsai_tpu_torch/csrc/`` (unpacked with
``git archive``, say) into a library of its own, binds ``bk_merge_fold``
and ``bk_minimizers`` with ctypes, and on one CUDA card, at the shapes
that ``chip_smoke.py`` times (the first 4M windows of a genome at k = 31,
W = 1 and W = 10; two 2^22-slot states with 3M valid entries each,
counts summed), checks that both revisions give the same output and times
them in turns: parent, change, change, parent.  Then it lists each
revision's kernels by device time from one ``torch.profiler`` window.

    python -m bonsai_tpu_torch.tools.kernel_ab PARENT_CSRC GENOME NODES

GENOME is a FASTA file, NODES a ``nodes.dmp`` whose taxids label the
states.  It prints one line per case, then the results as one JSON
object, and needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import kernels
from ..core import encoder as enc
from ..core.alphabet import DNA4
from ..db import build_device as bd
from ..db.table import unique_u64
from ..io import fastx
from ..taxonomy.tree import TaxTree
from .gather_bench import time_ms

SEED = 20261016
ITERS = 100  # calls a timing: a few ms of device time even at 30 us a call
OUT_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "kernel_ab")


def build_parent(csrc: str) -> ctypes.CDLL:
    """The parent's two kernels in one library, bound like ``kernels``."""
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = kernels._nvcc()
    objs, procs = [], []
    for name in ("merge_fold", "minimizers"):
        obj = os.path.join(OUT_DIR, f"parent_{name}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *kernels.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-c", "-o", obj, os.path.join(csrc, f"{name}.cu")],
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"parent kernel build failed:\n{err}")
    lib_path = os.path.join(OUT_DIR, "libparent.so")
    subprocess.run([nvcc, *kernels.ARCH, "-shared", "-o", lib_path, *objs],
                   check=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    for name in ("bk_merge_fold", "bk_minimizers"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = kernels._SIGS[name]
    lib.bk_merge_fold_scratch.restype = ctypes.c_int64
    lib.bk_merge_fold_scratch.argtypes = [ctypes.c_int64]
    return lib


def _call(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent kernel: CUDA error {err} at launch")


def parent_minimizers(lib, codes, lengths, k, W, canon):
    B, L = codes.shape
    E = L - k - W + 2
    keys = torch.empty((B, E), dtype=torch.int64, device=codes.device)
    emitted = torch.empty((B, E), dtype=torch.bool, device=codes.device)
    _call(lib.bk_minimizers, codes.data_ptr(), lengths.data_ptr(), B, L, k, W,
          int(canon), keys.data_ptr(), emitted.data_ptr())
    return enc.Emissions(keys, emitted)


def parent_merge_fold(lib, a, b, tax, root1, sum_counts):
    dev = a.keys.device
    N = a.cap + b.cap
    out = bd.State(torch.empty(N, dtype=torch.int64, device=dev),
                   torch.empty(N, dtype=torch.uint8, device=dev),
                   *(torch.empty(N, dtype=torch.int32, device=dev)
                     for _ in range(3)),
                   torch.empty((), dtype=torch.int64, device=dev))
    scratch = torch.empty(max(lib.bk_merge_fold_scratch(N), 1),
                          dtype=torch.uint8, device=dev)
    n = tax["depth"].shape[0]
    _call(lib.bk_merge_fold,
          *(t.data_ptr() for t in (a.keys, a.pad, a.node, a.orig, a.cnt)),
          a.cap,
          *(t.data_ptr() for t in (b.keys, b.pad, b.node, b.orig, b.cnt)),
          b.cap, tax["lift"].data_ptr(), tax["lift"].shape[0], n,
          tax["depth"].data_ptr(), tax["parent"].data_ptr(),
          tax["tax_ids"].data_ptr(), root1, int(sum_counts),
          *(t.data_ptr() for t in (out.keys, out.pad, out.node, out.orig,
                                   out.cnt, out.n)),
          scratch.data_ptr())
    return out


def _state(rng, pool, n, cap, taxa_pool, tree, dev):
    keys = np.sort(rng.choice(pool, n, replace=False))
    taxa = rng.choice(taxa_pool, n).astype(np.uint32)
    st = [np.full(cap, 2**64 - 1, np.uint64), np.ones(cap, np.uint8),
          np.zeros(cap, np.int32), np.zeros(cap, np.uint32),
          np.zeros(cap, np.uint32)]
    for arr, v in zip(st, (keys, 0, tree.compact(taxa, missing_ok=True), taxa,
                           1)):
        arr[:n] = v
    return bd.State.from_numpy(*st, n, dev)


def _device_ms(fn, calls=5):
    """Device milliseconds a call, by kernel name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if getattr(e, "device_type", None) == DeviceType.CUDA and us > 0:
            out[e.key[:60]] = us / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run(parent_csrc: str, genome: str, nodes: str, say=print) -> dict:
    dev = torch.device("cuda", 0)
    lib = build_parent(parent_csrc)
    res = {"cases": {}, "profile": {}}
    seq = next(iter(fastx.read_fastx(genome)))[1]
    cases = []
    for W in (1, 10):
        codes = fastx.encode_contig(seq[: (1 << 22) + 30 + W - 1], DNA4.lut)
        c = torch.from_numpy(codes[None, :]).to(dev)
        ln = torch.tensor([codes.size], dtype=torch.int32, device=dev)
        cases.append((f"minimizers k=31 W={W}",
                      lambda c=c, ln=ln, W=W: parent_minimizers(
                          lib, c, ln, 31, W, True),
                      lambda c=c, ln=ln, W=W: enc.minimizers(c, ln, 31, W,
                                                             True)))
    rng = np.random.default_rng(SEED)
    tree = TaxTree.from_nodes_dmp(nodes)
    taxa_pool = np.concatenate([tree.tax_ids, [0]]).astype(np.uint32)
    n = 3 << 20
    pool = unique_u64(rng.integers(0, 2**64, (5 << 20) + (5 << 16),
                                   dtype=np.uint64))[: 5 << 20]
    a = _state(rng, pool, n, 1 << 22, taxa_pool, tree, dev)
    b = _state(rng, pool, n, 1 << 22, taxa_pool, tree, dev)
    tax = tree.device_arrays(dev)
    root1 = int(tree.compact(np.array([1], dtype=np.uint32))[0])
    cases.append(("merge_fold 2^22 + 2^22, 3M valid each, sum_counts",
                  lambda: parent_merge_fold(lib, a, b, tax, root1, True),
                  lambda: bd.merge_fold(a, b, tax, root1, True)))
    for name, parent, change in cases:
        got, want = change(), parent()
        if isinstance(got, bd.State):
            got = [got.keys, got.pad, got.node, got.orig, got.cnt, got.n]
            want = [want.keys, want.pad, want.node, want.orig, want.cnt,
                    want.n]
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: parent and change differ")
        p1 = time_ms(parent, ITERS)
        c1 = time_ms(change, ITERS)
        c2 = time_ms(change, ITERS)
        p2 = time_ms(parent, ITERS)
        res["cases"][name] = {"parent_ms": [p1, p2], "change_ms": [c1, c2]}
        say(f"# {name}: parent {p1:.4f} ms, change {c1:.4f} ms, change "
            f"{c2:.4f} ms, parent {p2:.4f} ms (same output)")
        res["profile"][name] = {"parent": _device_ms(parent),
                                "change": _device_ms(change)}
        say(f"#   by kernel, ms a call: {res['profile'][name]}")
    return res


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 3:
        print("usage: python -m bonsai_tpu_torch.tools.kernel_ab PARENT_CSRC "
              "GENOME NODES", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"# {card}; torch {torch.__version__}")
    res = run(*args)
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
