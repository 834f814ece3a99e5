"""Each kernel's bound on an H100: the least time the card could take for
the work of one call, the larger of the bytes the work must move (each
input byte that it needs read once, each output byte written once) over
the memory rate and its int32 operations over the int32 peak; a u64
operation counts as two int32 operations.  ``chip_smoke.py`` and
``kernel_ab`` take their bounds from here, from the inputs and outputs of
the call that they time.
"""

from __future__ import annotations

import torch

# HBM3 at 3.35 TB/s (NVIDIA H100 SXM data sheet) and int32 ALU work at
# 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 TOP/s (Hopper architecture
# white paper); both at 700 W.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: int, ops: int = 0):
    """(least ms, "bytes" or "operations", bytes ms, operations ms): the
    larger of the bytes over the memory rate and the int32 operations over
    the int32 peak, and both."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations", tb, to)


def bound_text(b) -> str:
    return (f"bound {b[0]:.4f} ms ({b[1]}; bytes {b[2]:.4f} ms, int32 "
            f"operations {b[3]:.4f} ms)")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def k1_rows(out) -> int:
    """K1's slot rows: one per probe that hits in its first bucket at
    best, two per miss."""
    hit, valid = out[0], out[1]
    nv, nh = int(valid.sum()), int(hit.sum())
    return nh + 2 * (nv - nh)


def bound_encode_probe(inputs, vals, out):
    """K1: the packed reads, a 32-B slot row per ``k1_rows`` row, the
    values, the outputs; two splitmix64 hashes (~40 int32 ops) per valid
    position."""
    return bound(nbytes(*inputs, vals) + 32 * k1_rows(out) + nbytes(*out),
                 40 * int(out[1].sum()))


def resolve_work(cidx, hit, tax):
    """(bytes, int32 operations, which taxonomy figure counts) of K2 on
    these rows: the rows in and a taxon a read out, plus the smaller of
    the whole taxonomy arrays and the entries the work must read (8 B of
    tin/tout per distinct hit taxon of each read; per read with a hit one
    LCA walk's depth, lift and parent entries, 2 x (2 x levels + 1) x 4 B,
    and its tax_ids entry); per read of d distinct hit taxa, d^2
    count-weighted pairs of two compares and an add (they give the scores
    and the tied set of all hit pairs, as the JAX dedup branch shows)."""
    v = torch.where(hit, cidx, -1).sort(dim=1).values
    first = torch.ones_like(hit)
    first[:, 1:] = v[:, 1:] != v[:, :-1]
    d = (first & (v >= 0)).sum(-1, dtype=torch.int64)
    levels = tax["lift"].shape[0]
    entries = (8 * int(d.sum())
               + int((d > 0).sum()) * (8 * (2 * levels + 1) + 4))
    whole = nbytes(*tax.values())
    rows = nbytes(cidx, hit) + 4 * cidx.shape[0]
    side = "entries" if entries < whole else "whole arrays"
    return rows + min(entries, whole), 3 * int((d * d).sum()), side


def bound_resolve(cidx, hit, tax):
    """K2: ``resolve_work``."""
    return bound(*resolve_work(cidx, hit, tax)[:2])


def resolve_bound_text(cidx, hit, tax) -> str:
    nb, ops, side = resolve_work(cidx, hit, tax)
    return f"{bound_text(bound(nb, ops))}, the taxonomy's {side}"


def bound_minimizers(codes, lengths, em, W):
    """KB1: codes in, keys and flags out; per position two rolled u64
    k-mers and a canonical min (16 ops), with W > 1 a frev64 score and
    about three (score, value) compares (24 more)."""
    return bound(nbytes(codes, lengths, *em),
                 codes.numel() * (16 + (24 if W > 1 else 0)))


def bound_merge_fold(a, b, na, nb, tax, out):
    """KB3: keys and pad of every input slot, node, orig, cnt of the valid
    entries, the tree arrays, every output slot."""
    return bound(9 * (a.cap + b.cap) + 12 * (na + nb) + nbytes(*tax.values())
                 + nbytes(out.keys, out.pad, out.node, out.orig, out.cnt,
                          out.n))
