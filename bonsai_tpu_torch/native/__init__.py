"""Host C++ runtime of the port, loaded with ctypes.

The sources are ``native/src/*.cpp`` of this package (batch FASTA/FASTQ
parser, 2-bit batch packer, canonical k-mer sets, radix sort and
merge-fold, cuckoo placer, Kraken formatter), the port's own copy of the
JAX package's host runtime.  They compile into one library under the
git-ignored ``build/torch_native/`` of the checkout, at first use and
again whenever a source is newer.  There is no pure-Python fallback: a
failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libbtpu_host.so")

_lock = threading.Lock()
_lib = None


def _sources():
    return [
        os.path.join(SRC_DIR, f) for f in sorted(os.listdir(SRC_DIR))
        if f.endswith((".cpp", ".h"))
    ]


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [s for s in _sources() if s.endswith(".cpp")]
    # build to a per-process name and rename, so that concurrent processes
    # never load a half-written library
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           *srcs, "-o", tmp, "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"host library build failed ({' '.join(cmd)}):\n{proc.stderr}"
            )
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded host library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            stale = not os.path.exists(LIB_PATH) or os.path.getmtime(
                LIB_PATH
            ) < max(os.path.getmtime(s) for s in _sources())
            if stale:
                _build()
            lib = ctypes.CDLL(LIB_PATH)
            _declare(lib)
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the host library builds and loads here (the JAX package's
    ``native.available``); every host path of the port needs it."""
    try:
        get_lib()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _declare(lib) -> None:
    c = ctypes
    P, I64, I32 = c.c_void_p, c.c_int64, c.c_int32
    sigs = {
        "btpu_fastx_open": (P, [c.c_char_p]),
        "btpu_fastx_close": (None, [P]),
        "btpu_next_batch": (I64, [P, I64]),
        "btpu_last_error": (c.c_char_p, [P]),
        "btpu_batch_info": (None, [P, c.POINTER(I64), c.POINTER(I64),
                                   c.POINTER(I64), c.POINTER(I32),
                                   c.POINTER(I32)]),
        # names, name_offs, seqs, seq_offs, quals, qual_offs, lut, codes,
        # L, lengths
        "btpu_batch_fill": (None, [P, P, P, P, P, P, P, P, P, I64, P]),
        # seq, n, lut, k, canonical, out
        "btpu_canon_kmer_set": (I64, [P, I64, P, I32, I32, P]),
        # codes, n, L, lengths, Bp, w16, lproc, pcodes, nmask, nmw, nidx, cap
        "btpu_pack_batch": (I64, [P, I64, I64, P, I64, I64, I64, P, P, I64,
                                  P, I64]),
        "btpu_radix_sort_u64": (I32, [P, I64]),
        "btpu_radix_sort_kv": (I32, [P, P, I64]),
        "btpu_sort_dedup_u64": (I64, [P, I64]),
        # h, n, nb, bsalt, max_walk, owner, choice
        "btpu_cuckoo_place": (I32, [P, I64, I64, c.c_uint64, I32, P, P]),
        # n_runs, run_keys, run_lens, run_tins, run_tin_const, run_tvals,
        # run_tval_const, big, out_keys, tmin, tmax, nmiss, nnz, mmin,
        # mmax, count
        "btpu_merge_fold_stats": (I64, [I32, P, P, P, P, P, P, I32, P, P, P,
                                        P, P, P, P, P]),
        # n, names, name_offs, lengths, lengths2, taxon, taxa, hitmask, P,
        # n_missing, n_kmers, n_kmers1, comb_size, emit_all, out, cap
        "btpu_format_kraken": (I64, [I64, P, P, P, P, P, P, P, I64, P, P, P,
                                     I32, I32, P, I64]),
        # n, names, name_offs, lengths, lengths2, taxon, run_vals,
        # run_lens, n_runs, maxr, n_missing, n_kmers, n_kmers1, comb_size,
        # emit_all, out, cap
        "btpu_format_kraken_runs": (I64, [I64, P, P, P, P, P, P, P, P, I64,
                                          P, P, P, I32, I32, P, I64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
