"""Build and load the hand-written CUDA kernels under ``csrc/``.

The kernels (``csrc/*.cu``) have a plain C interface and are compiled
with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` of the
checkout (git-ignored), on first use and again whenever a source is newer,
then bound with ctypes.  Each ``.cu`` compiles to its own object in a
separate ``nvcc`` process, all started together, and one link makes the
library.  Every pointer and the stream pass as ``c_void_p``; each entry
point returns ``cudaGetLastError()`` after its launch, and ``launch``
raises when that is not 0.  The ``*_scratch`` functions are host-only:
they give the bytes of device scratch an entry point needs, which the
wrapper allocates.

The wrappers that call these hold the plain torch version beside each
kernel: ``classify/pipeline.py`` ``encode_probe`` and ``step_outputs``,
``encode_only`` (K1's two instantiations of the sharded classifier: the
bucket range is ``encode_probe`` of a ranged image; the sparse-N channel
is ``encode_probe`` with a list), ``encode_probe_radix`` and
``encode_only_radix`` (K1 radix, ``csrc/encode_probe_radix.cu``, on
another input type's int8 codes),
``classify/resolve.py`` ``resolve``, ``core/encoder.py`` ``minimizers``,
``compacted_minimizers`` and ``compacted_stream``, ``core/rolling.py``
``cyclic_hashes``, ``core/encode128.py`` ``pack_kmers128`` and ``rc128``,
``db/table.py`` ``lookup_scores`` and ``shard_owner``,
``db/build_device.py`` ``sort_unique``, ``merge_fold`` and
``key_range``, ``parallel/route.py`` ``route_frame``, ``route_probe`` and
``route_collect`` (KD1),
``core/hashes.py`` ``wang_hash``, ``khash_int64_hash``,
``frev64_inv``, ``wang_hash_inv`` and ``rotl`` and
``core/bitops.py`` ``popcount64`` and ``nuccount`` (one elementwise
kernel), ``sketch/hll.py`` ``hll_fill``, ``sketch/setsketch.py``
``csetsketch_update``, ``sketch/shs.py`` ``sort_count``, and
``tools/gather_bench.py`` ``row_gather`` and ``take_along`` (and the
yardstick ``empty_launch``, which has no plain version).  The plain
version serves CPU tensors only, and a CUDA tensor goes to the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libbonsai_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None

P, I64, I32, F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
U64 = ctypes.c_uint64
_SIGS = {
    # pcodes, w16, nmask, nmw, lengths, len16 (1: the lengths are u16, 0:
    # int32), B, P, k, canon, slots, lgnb, vbits, vals, n_vals, inline,
    # want_idx, hit, valid, cidx, oidx, stream
    "bk_encode_probe": [P, I64, P, I64, P, I32, I64, I64, I32, I32, P, I32,
                        I32, P, I64, I32, I32, P, P, P, P, P],
    # the same with a spaced seed: pcodes, w16, nmask, nmw, lengths, len16,
    # B, P, k, positions (host int32[32]), slots, lgnb, vbits, vals, n_vals,
    # inline, want_idx, hit, valid, cidx, oidx, stream
    "bk_encode_probe_spaced": [P, I64, P, I64, P, I32, I64, I64, I32, P, P,
                               I32, I32, P, I64, I32, I32, P, P, P, P, P],
    # the sparse-N channel: pcodes, w16, nidx, n_nidx, lengths, len16, B, P,
    # k, canon, spaced, positions (host int32[32] or null), slots, lgnb,
    # vbits, vals, n_vals, inline, want_idx, hit, valid, cidx, oidx, stream
    "bk_encode_probe_sparse": [P, I64, P, I64, P, I32, I64, I64, I32, I32,
                               I32, P, P, I32, I32, P, I64, I32, I32, P, P, P,
                               P, P],
    # cidx, hit, R, W, tin, tout, depth, parent, lift, levels, n, tax_ids,
    # taxon, dedup, stream
    "bk_resolve": [P, P, I64, I64, P, P, P, P, P, I32, I32, P, P, I32, P],
    # taxon, taxa, hit, valid, valid1, R, W, maxr, layout, vb, lb,
    # head_words, compact, cols, full, stream
    "bk_step_outputs": [P, P, P, P, P, I64, I64, I32, I32, I32, I32, I32, P,
                        I64, P, P],
    # pcodes, w16, nmask, nmw, lengths, len16, B, P, k, canon, spaced,
    # positions (host int32[32]), kmers, valid, stream
    "bk_encode_only": [P, I64, P, I64, P, I32, I64, I64, I32, I32, I32, P, P,
                       P, P],
    # pcodes, w16, nmask, nmw, lengths, len16, B, P, k, canon, spaced,
    # positions, slots, lgnb, vbits, vals, n_vals, inline, want_idx, row0,
    # rows, hit, valid, cidx, oidx, stream
    "bk_encode_probe_range": [P, I64, P, I64, P, I32, I64, I64, I32, I32, I32,
                              P, P, I32, I32, P, I64, I32, I32, I64, I64, P,
                              P, P, P, P],
    # another input type's codes: codes, ld, lengths, len16, B, P, k,
    # spaced, positions (host int32[32] or null), the fold (kind, bits,
    # radix, lim), slots, lgnb, vbits, vals, n_vals, inline, want_idx, hit,
    # valid, cidx, oidx, stream
    "bk_encode_probe_radix": [P, I64, P, I32, I64, I64, I32, I32, P, I32, I32,
                              U64, U64, P, I32, I32, P, I64, I32, I32, P, P,
                              P, P, P],
    # the same with row0, rows after want_idx
    "bk_encode_probe_radix_range": [P, I64, P, I32, I64, I64, I32, I32, P,
                                    I32, I32, U64, U64, P, I32, I32, P, I64,
                                    I32, I32, I64, I64, P, P, P, P, P],
    # codes, ld, lengths, len16, B, P, k, spaced, positions, the fold,
    # kmers, valid, stream
    "bk_encode_only_radix": [P, I64, P, I32, I64, I64, I32, I32, P, I32, I32,
                             U64, U64, P, P, P],
    # K1 radix's build: mode (0 whole table, 1 range, 2 encode only),
    # spaced, fold kind, out int32[6] (registers, local bytes, shared bytes,
    # blocks a SM, positions a thread, threads a block)
    "bk_encode_probe_radix_attrs": [I32, I32, I32, P],
    # kq, done, Q, ndb, cap, send, slotq, scratch, stream
    "bk_route_frame": [P, P, I64, I64, I64, P, P, P, P],
    # recv, n, slots, lgnb, vbits, vals, n_vals, inline, want_idx, resp,
    # stream
    "bk_route_probe": [P, I64, P, I32, I32, P, I64, I32, I32, P, P],
    # back, slotq, Q, dump, done, hit, cidx, oidx, pending, stream
    "bk_route_collect": [P, P, I64, I64, P, P, P, P, P, P],
    # keys, pad, n, lo, hi, last, flag, stream
    "bk_key_range": [P, P, I64, U64, U64, I32, P, P],
    # codes, lengths, B, L, k, W, canon, spaced, positions (host
    # int32[32]), span, unwindowed, then the fold (kind, bits, radix, lim),
    # the score (kind, denom), the phase-1 image (slots, lgnb, vbits, vals,
    # n_vals, inline), the Shannon score (terms, R, eps); keys, emitted,
    # stream
    "bk_minimizers_gen": [P, P, I64, I64, I32, I32, I32, I32, P, I32, I32,
                          I32, I32, U64, U64, I32, F64, P, I32, I32, P, I64,
                          I32, P, I32, F64, P, P, P],
    # codes, lengths, B, L, k, W, the fold, the score, the phase-1 image,
    # the Shannon score (as bk_minimizers_gen), canon, keys, emitted,
    # scratch, stream
    "bk_compacted_minimizers_gen": [P, P, I64, I64, I32, I32, I32, I32, U64,
                                    U64, I32, F64, P, I32, I32, P, I64, I32,
                                    P, I32, F64, I32, P, P, P, P],
    # codes, B, L, k, table_f, table_r (or null), n, values, invalid,
    # stream
    "bk_cyclic_hashes": [P, I64, I64, I32, P, P, I32, P, P, P],
    # kmers, n, the phase-1 image (slots, lgnb, vbits, vals, n_vals,
    # inline), out, stream
    "bk_lookup_scores": [P, I64, P, I32, I32, P, I64, I32, P, P],
    # the hash instantiations' blocks a SM: spaced, span, W, gen (KB1; gen:
    # another alphabet's spaced seed); W, gen (KB4)
    "bk_minimizers_hash_blocks_per_sm": [I32, I32, I32, I32],
    "bk_compacted_minimizers_hash_blocks_per_sm": [I32, I32],
    # K128's pack: its blocks a SM
    "bk_pack_kmers128_blocks_per_sm": [],
    # keys, emitted, E, cap, out_keys, out_pad, n_out, scratch, stream
    "bk_sort_unique": [P, P, I64, I64, P, P, P, P, P],
    # keys, pad, node, orig, cnt, cap (state a), the same for state b,
    # lift, levels, n, depth, parent, tax_ids, root1, sum_counts,
    # out keys, pad, node, orig, cnt, n_out, scratch, stream
    "bk_merge_fold": [P, P, P, P, P, I64, P, P, P, P, P, I64, P, I32, I32, P,
                      P, P, I32, I32, P, P, P, P, P, P, P, P],
    # keys, emitted, E, out_keys, out_counts, n_out, scratch, stream
    "bk_sort_count": [P, P, I64, P, P, P, P, P],
    # in, n, mode (0 wang_hash, 1 khash_int64_hash, 2 popcount64, 4
    # frev64_inv, 5 wang_hash_inv), out, stream
    "bk_bitmix": [P, I64, I32, P, P],
    # in, n, r, out, stream
    "bk_rotl": [P, I64, I32, P, P],
    # keys, n, ndb, owners (int32), stream
    "bk_shard_owner": [P, I64, I64, P, P],
    # codes, B, L, k, canon, hi, lo, invalid, stream
    "bk_pack_kmers128": [P, I64, I64, I32, I32, P, P, P, P],
    # hi, lo, n, k, mode (0 rc, 1 canonical), out_hi, out_lo, stream
    "bk_rc128": [P, P, I64, I32, I32, P, P, P],
    # values, valid, B, P, W, keys, emitted, scratch, stream
    "bk_compacted_stream": [P, P, I64, I64, I32, P, P, P, P],
    # kmers, n, mask, out (n, 4), stream
    "bk_nuccount": [P, I64, U64, P, P],
    # keys, n, p, wang, registers, stream
    "bk_hll_fill": [P, I64, I32, I32, P, P],
    # values, n, chunk, m, registers, ids, idcounts, scratch, stream
    "bk_csetsketch_update": [P, I64, I64, I64, P, P, P, P, P],
    # tbl, idx, R, Q, C, out, stream
    "bk_row_gather": [P, P, I64, I64, I64, P, P],
    # tab, idx, R, Ct, Q, Ci, axis, out, stream
    "bk_take_along": [P, P, I64, I64, I64, I64, I32, P, P],
    # blocks, cooperative (one grid barrier), stream
    "bk_empty_launch": [I64, I32, P],
}
# host functions of int64 arguments: bytes of device scratch for the sizes
# of a call, and KS3's plan (its bucket bits)
_SCRATCH = {"bk_sort_unique_scratch": 1, "bk_merge_fold_scratch": 1,
            "bk_compacted_minimizers_gen_scratch": 3,
            "bk_sort_count_scratch": 1, "bk_csetsketch_update_scratch": 3,
            "bk_route_frame_scratch": 2, "bk_sort_count_bits": 1}


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> float:
    """Compile the kernels now; returns the seconds it took."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs, procs = [], []
    t0 = time.perf_counter()
    try:
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, proc in procs:
            _, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"kernel build failed ({' '.join(cmd)}):\n{err}")
        tmp = f"{LIB_PATH}.{tag}"
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel link failed ({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in objs + [f"{LIB_PATH}.{tag}"]:
            if os.path.exists(f):
                os.unlink(f)
    return time.perf_counter() - t0


def get_lib():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(LIB_PATH) or os.path.getmtime(
                LIB_PATH
            ) < max(os.path.getmtime(s) for s in _sources()):
                build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, args in _SIGS.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = args
            for name, nargs in _SCRATCH.items():
                fn = getattr(lib, name)
                fn.restype = I64
                fn.argtypes = [I64] * nargs
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry point ``name`` on ``device``'s current stream;
    raise if the launch was refused."""
    fn = getattr(get_lib(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def scratch(name: str, n, device: torch.device) -> torch.Tensor:
    """Device scratch for entry point ``name`` over ``n`` elements (or the
    tuple of sizes its scratch function takes)."""
    nbytes = getattr(get_lib(), f"{name}_scratch")(
        *(n if isinstance(n, tuple) else (n,)))
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)


def ptr(t):
    """data_ptr of a tensor, or None for a missing optional input."""
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, device,
          shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape`` where given)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
