"""Classification output: Kraken-style text and FASTQ re-emission.

Counterpart of ``bonsai_tpu/classify/output.py``, byte for byte
(classifier.h:112-129,339-412).  Kraken records go through the host C++
formatter (``kraken_out.cpp``), which reads the batch's names from a
``Strings``' arena and offsets in place; names given as a list are joined
into one first, under the span ``name_join``.  The ``-f`` FASTQ
re-emission is formatted here.

kraken record:
    C|U \\t name \\t taxon \\t len \\t [M:missing \\t] [A:ambig \\t] runs\\n
where runs are the run-length encoded hit taxids "tax:count" (0 -> 'U',
0xFFFFFFFF -> 'A'), or "0:0" when unclassified.  The ambiguity count keeps
the reference's u32 arithmetic, which wraps for reads shorter than the
seed.  Every ``comb_size`` here is the seed's span c (the Spacer's comb
size, k + the gaps), which a spaced seed makes larger than k; the
classifier passes ``Spacer.c``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..io.fastx import Strings
from ..native import get_lib
from ..util import span

TAX_AMBIG = 0xFFFFFFFF


def _runs(taxa: np.ndarray) -> List[str]:
    """RLE of a hit-taxa sequence."""
    if taxa.size == 0:
        return []
    change = np.nonzero(np.diff(taxa))[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [taxa.size]])
    parts = []
    for s, e in zip(starts, ends):
        t = int(taxa[s])
        code = "U" if t == 0 else "A" if t == TAX_AMBIG else str(t)
        parts.append(f"{code}:{e - s}")
    return parts


def format_read(name: str, taxon: int, length: int, missing: int,
                ambig: int, hit_taxa: np.ndarray) -> str:
    """One Kraken record of a read, in Python (output.py:46): the host
    C++ formatter writes the same bytes for a batch."""
    cols = ["C" if taxon else "U", name, str(taxon), str(length)]
    if missing:
        cols.append(f"M:{missing}")
    if ambig:
        cols.append(f"A:{ambig}")
    if taxon:
        cols.extend(_runs(hit_taxa))
        return "\t".join(cols) + "\n"
    return "\t".join(cols) + "\t0:0\n"


def ambig_count(res, i: int, comb_size: int) -> int:
    """The reference's ambiguous-position count (classifier.h:232-240) in
    u32 wrap-around.  Paired: after mate 1, l1 - c + 1 - valid1; mate 2
    then adds l2 - (c - 1) - valid_total."""
    l1 = int(res.lengths[i])
    v1 = int(res.n_kmers1[i]) if res.n_kmers1 is not None else int(res.n_kmers[i])
    ambig = (l1 - comb_size + 1 - v1) & 0xFFFFFFFF
    if res.paired:
        l2 = int(res.lengths2[i])
        ambig = (ambig + l2 - (comb_size - 1) - int(res.n_kmers[i])) & 0xFFFFFFFF
    return ambig


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint32)


def _format_kraken(res, comb_size: int, emit_all: bool, acc=None) -> str:
    """Kraken text of a batch through the host C++ formatter.  Names that
    are not ``Strings`` are joined into an arena first, in the span
    ``name_join`` (accumulated into ``acc``, as ``util.span`` does)."""
    lib = get_lib()
    names = res.names
    n = len(names)
    if n == 0:
        return ""
    if not isinstance(names, Strings):
        with span("name_join", acc):
            names = Strings.of(names)
    name_offs = np.ascontiguousarray(names.offs, dtype=np.int64)
    names_arena = names.arena.ctypes.data
    name_bytes = int(name_offs[-1] - name_offs[0])
    lengths = _i32(res.lengths)
    lengths2 = _i32(res.lengths2) if res.paired else None
    l2_ptr = lengths2.ctypes.data if lengths2 is not None else None
    taxon = _u32(res.taxon)
    n_missing = _i32(res.n_missing)
    n_kmers = _i32(res.n_kmers)
    n_kmers1 = _i32(res.n_kmers1) if res.n_kmers1 is not None else n_kmers
    if res.compact:
        run_vals = _u32(res.run_vals)
        run_lens = _u32(res.run_lens)
        n_runs = _i32(res.n_runs)
        maxr = run_vals.shape[1] if run_vals.ndim == 2 else 0
        cap = name_bytes + n * 80 + int(n_runs.sum()) * 25 + 1024

        def call(out, cap):
            return lib.btpu_format_kraken_runs(
                n, names_arena, name_offs.ctypes.data, lengths.ctypes.data,
                l2_ptr, taxon.ctypes.data, run_vals.ctypes.data,
                run_lens.ctypes.data, n_runs.ctypes.data, maxr,
                n_missing.ctypes.data, n_kmers.ctypes.data,
                n_kmers1.ctypes.data, comb_size, int(emit_all),
                out.ctypes.data, cap,
            )
    else:
        taxa = _u32(res.taxa)
        hm = np.ascontiguousarray(res.hit_mask, dtype=np.uint8)
        P = taxa.shape[1] if taxa.ndim == 2 else 0
        cap = name_bytes + n * 80 + int(hm.sum()) * 14 + 1024

        def call(out, cap):
            return lib.btpu_format_kraken(
                n, names_arena, name_offs.ctypes.data, lengths.ctypes.data,
                l2_ptr, taxon.ctypes.data, taxa.ctypes.data, hm.ctypes.data,
                P, n_missing.ctypes.data, n_kmers.ctypes.data,
                n_kmers1.ctypes.data, comb_size, int(emit_all),
                out.ctypes.data, cap,
            )
    while True:
        out = np.empty(cap, dtype=np.uint8)
        wrote = call(out, cap)
        if wrote >= 0:
            return out[:wrote].tobytes().decode("utf-8", "replace")
        cap = -wrote  # buffer too small: the formatter says how much


def format_batch(res, comb_size: int, emit_all: bool = False,
                 emit_kraken: bool = True, emit_fastq: bool = False,
                 acc=None) -> str:
    """res: classify.pipeline.BatchResult (one row per read or mate pair).
    ``acc``: the spans' accumulator (``Classifier.span_seconds``)."""
    if emit_kraken and not emit_fastq:
        return _format_kraken(res, comb_size, emit_all, acc)
    if not emit_fastq:
        return ""
    return _format_fastq(res, comb_size, emit_all, emit_kraken)


def _format_fastq(res, comb_size: int, emit_all: bool,
                  emit_kraken: bool) -> str:
    """FASTQ re-emission with the classification in the header comment."""
    out: List[str] = []
    # as lists once: a ``Strings`` read item by item costs ~8x its tolist
    names = list(res.names)
    mates = [(list(res.seqs), res.quals and list(res.quals))]
    if res.paired:
        mates.append((list(res.seqs2), res.quals2 and list(res.quals2)))
    for i in range(len(names)):
        taxon = int(res.taxon[i])
        if not (emit_all or taxon):
            continue
        name = names[i].decode("utf-8", "replace")
        comment = _fastq_comment(
            taxon, int(res.lengths[i]), int(res.n_missing[i]),
            ambig_count(res, i, comb_size), res.hit_taxa(i), emit_kraken,
        )
        for seqs, quals in mates:
            q = quals[i] if quals and quals[i] else seqs[i]
            out.append(f"{name} {comment}\n")
            out.append(seqs[i].decode("ascii", "replace") + "\n+\n")
            out.append(q.decode("ascii", "replace") + "\n")
    return "".join(out)


def _fastq_comment(taxon, length, missing, ambig, hits, verbose) -> str:
    cols = ["C" if taxon else "U", str(taxon), str(length)]
    if missing:
        cols.append(f"M:{missing}")
    if ambig:
        cols.append(f"A:{ambig}")
    s = "\t".join(cols)
    if verbose:
        s += "\t" + "\t".join(_runs(hits)) if taxon else "\t0:0"
    return s
