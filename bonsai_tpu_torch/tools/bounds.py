"""Each kernel's bound on an H100: the least time the card could take for
the work of one call, the larger of the bytes the work must move (each
input byte that it needs read once, each output byte written once) over
the memory rate and its operations over the peak rate of their type:
int32 operations over the int32 peak (a u64 operation counts as two),
and the entropy scores' double adds and divides over the FP64 peak (the
entropy-file score's one divide a seed; the Shannon score's d terms of
a seed of d distinct codes, H + eps and the divide).  ``chip_smoke.py`` and
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
# FP64 outside the tensor cores, 34 TFLOP/s (NVIDIA H100 SXM data sheet)
FP64_OPS_PER_S = 34e12


def bound(nbytes: int, ops: int = 0, fp64: int = 0):
    """(least ms, "bytes" or "operations", bytes ms, operations ms): the
    larger of the bytes over the memory rate and the operations over
    their peak (int32 operations over the int32 peak, or FP64 operations
    over the FP64 peak, the larger), and both."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(ops / INT32_OPS_PER_S, fp64 / FP64_OPS_PER_S) * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations", tb, to)


def bound_text(b) -> str:
    return (f"bound {b[0]:.4f} ms ({b[1]}; bytes {b[2]:.4f} ms, "
            f"operations {b[3]:.4f} ms)")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def k1_rows(out) -> int:
    """K1's slot rows: one per probe that hits in its first bucket at
    best, two per miss."""
    hit, valid = out[0], out[1]
    nv, nh = int(valid.sum()), int(hit.sum())
    return nh + 2 * (nv - nh)


def spaced_runs(positions) -> int:
    """Runs of consecutive offsets in a spaced seed (0x16,1x4: 5)."""
    return 1 + sum(b != a + 1 for a, b in zip(positions, positions[1:]))


def fold_ops(out, runs: int = 0, rolled: bool = False,
             positions=None) -> int:
    """The int32 operations of K1's encode at every position of ``out``
    (at ``positions`` of them where given): for a spaced seed of ``runs``
    runs of consecutive offsets its fold out of the position's window (a
    u64 shift, mask and or a run, 4 int32 ops at the least; another input
    type's spaced seed folds each of its codes, a run of one where no two
    offsets touch), and for another input type's contiguous seed
    (``rolled``) a rolled fold, the incoming code's u64 multiply-add and
    the outgoing code's (8 int32 ops at the least)."""
    n = out[1].numel() if positions is None else positions
    return (4 * runs + 8 * rolled) * n


def in_read(inputs, out, c: int):
    """K1 over the reads' own positions, not the padded (B, P) grid: the
    positions p < len - (c - 1) of each read, and the bytes of the reads'
    own codes.  ``inputs`` is (codes (B, L) int8, lengths): another input
    type's reads, one byte a code.  -> (positions, bytes of the inputs,
    bytes of the outputs at those positions)."""
    codes, lengths = inputs
    B, L = codes.shape
    P = out[1].shape[1]
    ln = lengths.to(torch.int64)
    n = int((ln - (c - 1)).clamp(0, P).sum())
    code_bytes = int(ln.clamp(0, L).sum())
    per = sum(t.element_size() for t in out)
    return n, code_bytes + nbytes(lengths), n * per


def _k1_io(inputs, out, runs, rolled, inread):
    """(bytes in and out, fold ops) of K1's encode: over the padded grid,
    or with ``inread`` (the seed's span c) over the reads' own positions
    (``in_read``)."""
    if inread is None:
        return nbytes(*inputs, *out), fold_ops(out, runs, rolled)
    n, nin, nout = in_read(inputs, out, inread)
    return nin + nout, fold_ops(out, runs, rolled, n)


def bound_encode_probe(inputs, vals, out, runs: int = 0,
                       rolled: bool = False, inread=None):
    """K1: the packed reads (``inputs``: words, the N mask or, for the
    sparse-N instantiation, the list of cap x 4 B, lengths; for another
    input type's radix instantiations its int8 codes, one byte a code,
    and the lengths), a 32-B slot row per ``k1_rows`` row, the values, the
    outputs; two splitmix64 hashes (~40 int32 ops) per valid position, and
    the encode's ``fold_ops``.  The sparse list's block-wide search is a
    few operations a block, under the probes' hashes.  With ``inread``
    (the seed's span; the radix instantiations' inputs) the codes and the
    outputs count at the reads' own positions only (``in_read``)."""
    io, ops = _k1_io(inputs, out, runs, rolled, inread)
    return bound(io + nbytes(vals) + 32 * k1_rows(out),
                 40 * int(out[1].sum()) + ops)


def bound_encode_only(inputs, out, runs: int = 0, rolled: bool = False,
                      inread=None):
    """K1's encode-only instantiation: the reads in (as
    ``bound_encode_probe``'s), the k-mers and flags out, the encode's
    ``fold_ops``; ``inread`` as ``bound_encode_probe``'s."""
    return bound(*_k1_io(inputs, out, runs, rolled, inread))


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


def bound_minimizers(codes, lengths, em, W, runs: int = 0,
                     entropy: bool = False, probes=None, fp64: int = 0):
    """KB1: codes in, keys and flags out; per position two rolled u64
    k-mers and a canonical min (16 ops), or for a spaced seed of ``runs``
    runs of consecutive offsets a rolled window and its fold (8 ops and 4
    a run); with W > 1 a score and about three (score, value) compares
    (24 more), the score an FP64 divide a position under ``entropy``, or
    under the scheme ``hash`` the phase-1 probes ``probes`` (``probe_rows``
    of ``hash_queries``: their rows and values, ~40 int32 ops each), or
    the Shannon score's ``fp64`` (``shannon_fp64``).  Another alphabet's
    fold counts as DNA's: a rolled multiply-add and modulus test are no
    more int32 work than two rolled 2-bit k-mers and their minimum."""
    per = 8 + 4 * runs if runs else 16
    hb, ho = (probe_bytes(probes), 40 * probes[0]) if probes else (0, 0)
    return bound(nbytes(codes, lengths, *em) + hb,
                 codes.numel() * (per + (24 if W > 1 else 0)) + ho,
                 (codes.numel() if entropy and W > 1 else 0) + fp64)


def bound_compacted_minimizers(codes, lengths, em, W, entropy: bool = False,
                               probes=None, fp64: int = 0):
    """KB4: codes in, keys and flags out; per position a rolled
    u64 k-mer and its valid flag (8 ops) and with W > 1 a score and about
    three compares (24 more), the score an FP64 divide under ``entropy``,
    or under ``hash`` the phase-1 probes of the valid seeds, ``probes``,
    or the Shannon score's ``fp64`` (``shannon_fp64``)."""
    hb, ho = (probe_bytes(probes), 40 * probes[0]) if probes else (0, 0)
    return bound(nbytes(codes, lengths, *em) + hb,
                 codes.numel() * (8 + (24 if W > 1 else 0)) + ho,
                 (codes.numel() if entropy and W > 1 else 0) + fp64)


def shannon_fp64(codes, lengths, k, n_codes, positions=None) -> int:
    """The FP64 operations of the Shannon scores of a row's seeds: per
    seed without an ambiguous code inside the row, its d distinct codes'
    terms added, H + eps and the divide (d + 2).  Counted from this call's
    codes (``window_code_counts`` / ``spaced_code_counts``) in slices of
    2^20 positions."""
    from ..core.entropy import spaced_code_counts, window_code_counts

    c = k if positions is None else int(positions[-1]) + 1
    total = 0
    for b in range(codes.shape[0]):
        row = codes[b, : int(lengths[b])]
        P = row.shape[-1] - c + 1
        for s in range(0, max(P, 0), 1 << 20):
            sl = row[s: s + (1 << 20) + c - 1]
            cnt = (window_code_counts(sl, k, n_codes) if positions is None
                   else spaced_code_counts(sl, positions, n_codes))
            valid = cnt.sum(-1) == k
            total += int(((cnt > 0).sum(-1) + 2)[valid].sum())
    return total


def bound_cyclic_hashes(codes, out, canon: bool):
    """KR1: codes in, values and flags out; per window a rolled hash, two
    64-bit rotates, two xors and two table reads (16 int32 ops), twice
    with the reverse complement and their minimum (36)."""
    return bound(nbytes(codes, *out), out[0].numel() * (36 if canon else 16))


def _first_found(q, arr):
    """(whether each of the queries ``q`` sits in its first bucket, whether
    the image holds it)."""
    from ..core.bitops import SIGN
    from ..core.hashes import splitmix64
    from ..db.table import probe_slots, split

    b1, quo, _ = split(splitmix64(q), arr.lgnb)
    vmask = (1 << arr.vbits) - 1
    first = ((arr.slots[b1] & ~vmask) ==
             (SIGN | (quo << arr.vbits))[:, None]).any(-1)
    return first, probe_slots(q, arr)[1]


def probe_rows(queries, arr):
    """(probes, 32-B slot rows, values) that probing ``queries`` in the
    slot image ``arr`` must read: one row where a query sits in its first
    bucket, two for any other query (the second row is read only then),
    and a value for each query found."""
    q = queries.reshape(-1)
    first, found = _first_found(q, arr)
    return q.numel(), 2 * q.numel() - int(first.sum()), int(found.sum())


def probe_split(queries, arr) -> dict:
    """A received frame's keys by how their probe ends: the U64_MAX rows
    (``pads``: the frame's unused rows, and any real query of that key),
    and of the others those found in their first bucket (``row1``), in
    their second (``row2``) and ``missing``."""
    q = queries.reshape(-1)
    first, found = _first_found(q, arr)
    pad = q == -1
    return {"pads": int(pad.sum()), "row1": int((~pad & first).sum()),
            "row2": int((~pad & found & ~first).sum()),
            "missing": int((~pad & ~found).sum())}


def probe_bytes(probes) -> int:
    """The bytes of ``probe_rows``' rows and values."""
    _, rows, found = probes
    return 32 * rows + 8 * found


def bound_lookup_scores(kmers, arr, out):
    """KB5: the k-mers in, the scores out, the slot rows and values of
    ``probe_rows``; two splitmix64 hashes (~40 int32 ops) a k-mer."""
    probes = probe_rows(kmers, arr)
    return bound(nbytes(kmers, out) + probe_bytes(probes), 40 * probes[0])


def hash_queries(codes, lengths, k, canon, positions=None, it=None):
    """The k-mers a windowed discipline of the scheme ``hash`` must probe:
    the canonical k-mer (0 for an N window) or the spaced one (U64_MAX for
    an N seed) of each position below max(len - (c - 1), 0), or with
    ``canon`` None (the uncanonical ``-C -w``) each valid seed; of DNA, or
    of the input type ``it`` (its fold)."""
    from ..core import encode
    from ..core.alphabet import InputType
    from ..core.bitops import canonical

    it = InputType.DNA if it is None else InputType(it)
    if positions is None:
        kmers, invalid = encode.pack_kmers(codes, k, it)
        c = k
    else:
        offsets = [int(b) - int(a) for a, b in zip(positions, positions[1:])]
        kmers, invalid = encode.pack_spaced_kmers(codes, offsets, it)
        c = int(positions[-1]) + 1
    kmers = encode.apply_mask(kmers, k, it)
    P = kmers.shape[-1]
    pushed = encode.position_validity(lengths, P, c)
    if canon is None:
        return kmers[pushed & ~invalid]
    if positions is None:
        return torch.where(invalid, 0, canonical(kmers, k))[pushed]
    return torch.where(invalid, -1, kmers)[pushed]


def bound_merge_fold(a, b, na, nb, tax, out):
    """KB3: keys and pad of every input slot, node, orig, cnt of the valid
    entries, the tree arrays, every output slot."""
    return bound(9 * (a.cap + b.cap) + 12 * (na + nb) + nbytes(*tax.values())
                 + nbytes(out.keys, out.pad, out.node, out.orig, out.cnt,
                          out.n))


def bound_bitmix(x, out):
    """KS4: each value read once and its result written once (8 B, or
    nuccount's four 8-B counts); a dozen int32 operations a value at
    most, far below the bytes."""
    return bound(nbytes(x, out), 24 * x.numel())


def bound_hll_fill(keys, p: int, wang: bool):
    """KS1: 8 B a key in, the 2^p u32 registers read and written once; a
    key's wang_hash (7 steps of u64 shifts, adds, xors and multiplies,
    ~30 int32 ops) and its index, rho and compare (~12)."""
    return bound(nbytes(keys) + 8 * (1 << p),
                 keys.numel() * ((30 if wang else 0) + 12))


# an arrival of KS2: two splitmix finalizers of 3 xor-shifts and 2 u64
# multiplies each, the counter's multiply-add and the u64 modulus (about
# 60 int32 ops); CUDA's double log (about 20 FP64 ops: reduction and a
# polynomial), the divide, the two adds of the time and the conversion
# (about 25 FP64 ops)
CSS_INT32_OPS, CSS_FP64_OPS = 60, 25


def bound_csetsketch(values, m: int, arrivals: int):
    """KS2: the values in, the m f64 registers read and written once; per
    arrival CSS_INT32_OPS and CSS_FP64_OPS.  ``arrivals``: those any exact
    schedule evaluates (``csetsketch_update_plain.required``: below their
    round's threshold, and the one that ends each element), not the JAX
    package's 16 a live element a round, which a kernel that stops at an
    element's first arrival past the threshold does not do."""
    return bound(nbytes(values) + 16 * m, CSS_INT32_OPS * arrivals,
                 CSS_FP64_OPS * arrivals)


def css_required(values, regs) -> int:
    """The arrivals that any exact schedule evaluates to update the f64
    registers ``regs`` (left as they are) by ``values``:
    ``csetsketch_update_plain.required`` of the plain version's run on a
    copy.  From +inf registers, a new sketch; from the registers the same
    values made, a full one."""
    from ..sketch.setsketch import csetsketch_update_plain

    before = csetsketch_update_plain.required
    csetsketch_update_plain(values, regs.clone(), None, None)
    return csetsketch_update_plain.required - before


def bound_sort_count(keys, emitted, out):
    """KS3: as KB2, the keys and flags in, the distinct keys and their
    u16 counts out."""
    return bound(nbytes(keys, emitted, *out))


def bound_shard_owner(keys, out):
    """KS5: 8 B a key in and its 4-B owner out; splitmix64 (3 xor-shifts,
    2 u64 multiplies, an add: ~20 int32 ops) and the owner's shift,
    multiply and shift (~6)."""
    return bound(nbytes(keys, out), 26 * keys.numel())


def bound_pack_kmers128(codes, out, canon: bool):
    """K128 pack: 1 B of codes a position in, two 8-B lanes and a flag
    out; per position the rolled 128-bit k-mer (two u64 shifts, an or,
    a carry and a mask: ~10 int32 ops) and its flags (~4), and with
    ``canon`` the rc of both lanes (5 swap steps of 4 u64 ops and the
    stitch, ~50 int32 ops) and the 128-bit compare (~8)."""
    return bound(nbytes(codes, *out), out[0].numel() * (14 + (58 if canon
                                                              else 0)))


def bound_rc128(pairs, out, canon: bool):
    """K128 rc / canonical: 16 B a pair in and 16 B out; the rc of both
    lanes (~50 int32 ops) and with ``canon`` the compare (~8)."""
    return bound(nbytes(*pairs, *out), pairs[0].numel() * (58 if canon
                                                           else 50))


def bound_compacted_stream(values, valid, em, W):
    """KB4's stream source: 9 B a position in and 9 B a slot out; per
    position its flag (2 ops) and with W > 1 frev64
    (~12) and about three (score, value) compares (24)."""
    return bound(nbytes(values, valid, *em),
                 values.numel() * (2 + (36 if W > 1 else 0)))


def bound_route_frame(kq, done, out):
    """KD1 frame: 8 B and a flag a query in, its 4-B row out, the frame's
    8-B rows out; each pending query's owner (splitmix64 and the owner's
    multiply, ~26 int32 ops, as KS5)."""
    pending = int((~done).sum())
    return bound(nbytes(kq, done, *out), 26 * pending)


def bound_route_probe(recv, arr, resp):
    """KD1 probe: 8 B a received key in, 8 B out, the slot rows and values
    of ``probe_rows``; two splitmix64 hashes (~40 int32 ops) a key."""
    probes = probe_rows(recv, arr)
    return bound(nbytes(recv, resp) + probe_bytes(probes), 40 * probes[0])


def bound_route_collect(slotq, done, routed: int):
    """KD1 collect: each query's 4-B row and its done flag read and the
    flag written; for each of the ``routed`` queries sent this round, its
    8-B response read and hit, cidx, oidx (9 B) written."""
    return bound(nbytes(slotq) + 2 * nbytes(done) + 17 * routed)


def bound_key_range(keys, pad, flag):
    """The key-range pass: 8 B and a pad byte in, a flag out a key; two
    unsigned 64-bit compares (~6 int32 ops)."""
    return bound(nbytes(keys, pad, flag), 6 * keys.numel())


def range_rows(queries, arr) -> int:
    """The slot rows K1's bucket-range instantiation must read for these
    (valid) queries: a query whose first bucket lies in the rank's rows
    reads it; one that finds no match there and whose second bucket lies
    in them reads that too."""
    from ..core.bitops import SIGN
    from ..core.hashes import splitmix64
    from ..db.table import split

    h = splitmix64(queries)
    b1, q, b2 = split(h, arr.lgnb)
    vmask = (1 << arr.vbits) - 1
    l1, l2 = b1 - arr.row0, b2 - arr.row0
    in1 = (l1 >= 0) & (l1 < arr.rows)
    in2 = (l2 >= 0) & (l2 < arr.rows)
    row = arr.slots[l1.clamp(0, arr.rows - 1)]
    hit1 = in1 & ((row & ~vmask) == (SIGN | (q << arr.vbits))[..., None]
                  ).any(-1)
    return int(in1.sum()) + int((in2 & ~hit1).sum())


def bound_encode_probe_range(inputs, vals, out, queries, arr,
                             runs: int = 0, rolled: bool = False,
                             inread=None):
    """K1's bucket-range instantiation: the packed reads (or another input
    type's codes), the rank's slot rows (``range_rows``), the values, the
    outputs; two splitmix64 hashes (~40 int32 ops) a valid position and
    the encode's ``fold_ops``; ``inread`` as ``bound_encode_probe``'s."""
    io, ops = _k1_io(inputs, out, runs, rolled, inread)
    return bound(io + nbytes(vals) + 32 * range_rows(queries, arr),
                 40 * int(out[1].sum()) + ops)
