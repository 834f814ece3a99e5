"""Per-read resolve: hit positions -> one taxon (K2).

``resolve`` is the wrapper of the CUDA kernel ``csrc/resolve.cu``; its
plain torch version is ``resolve_plain`` = ``resolve_batch`` + the taxid
gather, a port of ``bonsai_tpu/classify/resolve.py`` with its three
branches.  With Euler-interval labels the root-path weight of a hit is

    score(p) = #{hits q : tin[q] <= tin[p] <= tout[q]}

(resolve_tree, util.h:831-869); ties resolve to LCA(first argmin tin,
first argmax tin) by binary lifting.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import kernels


def lca_device(a_idx: torch.Tensor, b_idx: torch.Tensor,
               tax: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pairwise LCA over compact indices (0 = none), with lca(x, 0) = x."""
    lift, depth = tax["lift"], tax["depth"]
    a = a_idx.to(torch.int64)
    b = b_idx.to(torch.int64)
    a0, b0 = a, b
    da = depth[a]
    db = depth[b]
    for j in range(lift.shape[0] - 1, -1, -1):
        step = 1 << j
        la = (da - db) >= step
        a = torch.where(la, lift[j][a].to(torch.int64), a)
        da = torch.where(la, da - step, da)
        lb = (db - da) >= step
        b = torch.where(lb, lift[j][b].to(torch.int64), b)
        db = torch.where(lb, db - step, db)
    neq = a != b
    for j in range(lift.shape[0] - 1, -1, -1):
        pa = lift[j][a].to(torch.int64)
        pb = lift[j][b].to(torch.int64)
        move = neq & (pa != pb)
        a = torch.where(move, pa, a)
        b = torch.where(move, pb, b)
    res = torch.where(neq, tax["parent"][a].to(torch.int64), a)
    res = torch.where(a0 == 0, b0, res)
    res = torch.where(b0 == 0, torch.where(a0 == 0, 0, a0), res)
    return res


def _pick(score, t_in, mask, idx, tax, big, any_hit):
    """Tie resolution shared by the branches: LCA of the first tin-min and
    first tin-max among the best-scoring hits; 0 for a row with no hit."""
    score = torch.where(mask, score, -1)
    best = score.max(dim=-1, keepdim=True).values
    tied = (score == best) & mask
    i_min = torch.where(tied, t_in, big).argmin(dim=-1, keepdim=True)
    i_max = torch.where(tied, t_in, -1).argmax(dim=-1, keepdim=True)
    a = idx.gather(-1, i_min)[:, 0]
    b = idx.gather(-1, i_max)[:, 0]
    taxon = lca_device(a, b, tax)
    return torch.where(any_hit, taxon, 0)


def dedup_rule(n_distinct: Optional[int], P: int) -> bool:
    """Whether ``resolve_batch`` takes its dedup branch for rows of width
    ``P`` (``bonsai_tpu/classify/resolve.py:82-87``).  Its ties in tin go
    to the smaller compact index; the dense and blockwise branches' to the
    first position.  The two differ only where tin is not injective: the
    nodes of a parent cycle, never visited, share the root's tin of 0."""
    return (n_distinct is not None and n_distinct > 0 and P > 256
            and min(n_distinct, P) <= P // 2)


def resolve_batch(hit_idx: torch.Tensor, hit_mask: torch.Tensor,
                  tax: Dict[str, torch.Tensor], block: int = 1024,
                  n_distinct: Optional[int] = None) -> torch.Tensor:
    """(B, P) compact indices of hits + mask -> (B,) compact index of the
    resolved taxon (0 = unclassified).  Dense (B, P, P) ancestor matrix;
    past ``block`` positions the q axis is scanned in blocks; with
    ``n_distinct`` small against P > 256, rows dedup to D distinct taxa
    with counts and the matrix shrinks to (B, D, D)."""
    tin, tout = tax["tin"], tax["tout"]
    B, P = hit_idx.shape
    big = tin.shape[0] + 2
    hit_idx = hit_idx.to(torch.int64)
    if dedup_rule(n_distinct, P):
        return _resolve_dedup(hit_idx, hit_mask, tax, min(int(n_distinct), P))
    t_in = torch.where(hit_mask, tin[hit_idx], big)
    t_out = torch.where(hit_mask, tout[hit_idx], -2)
    score = torch.zeros((B, P), dtype=torch.int64, device=hit_idx.device)
    for q0 in range(0, P, block):
        ti_b = t_in[:, q0 : q0 + block]
        to_b = t_out[:, q0 : q0 + block]
        # anc[b, q, p]: hit q is an ancestor-or-self of hit p
        anc = (ti_b[:, :, None] <= t_in[:, None, :]) & (
            t_in[:, None, :] <= to_b[:, :, None]
        )
        score += anc.sum(dim=1)
    return _pick(score, t_in, hit_mask, hit_idx, tax, big,
                 hit_mask.any(dim=-1))


def _resolve_dedup(hit_idx, hit_mask, tax, D: int):
    """Distinct-taxa resolve: per-row sort + dedup to D slots with counts;
    count-weighted scores equal the dense sums exactly."""
    tin, tout = tax["tin"], tax["tout"]
    B, P = hit_idx.shape
    n = tin.shape[0]
    big = n + 2
    sent = n + 1  # sorts after every real compact index
    sv = torch.where(hit_mask, hit_idx, sent).sort(dim=1).values
    first = torch.ones_like(sv, dtype=torch.bool)
    first[:, 1:] = sv[:, 1:] != sv[:, :-1]
    first &= sv != sent
    rank = first.to(torch.int64).cumsum(dim=1) - 1
    zeros = torch.zeros((B, D + 1), dtype=torch.int64, device=sv.device)
    dvals = zeros.scatter(1, torch.where(first, rank, D), sv)[:, :D]
    counts = zeros.scatter_add(
        1, torch.where(sv != sent, rank, D), torch.ones_like(sv)
    )[:, :D]
    dmask = counts > 0
    t_in = torch.where(dmask, tin[dvals], big)
    t_out = torch.where(dmask, tout[dvals], -2)
    anc = (t_in[:, :, None] <= t_in[:, None, :]) & (
        t_in[:, None, :] <= t_out[:, :, None]
    )
    score = (anc * counts[:, :, None]).sum(dim=1)
    return _pick(score, t_in, dmask, dvals, tax, big, hit_mask.any(dim=-1))


def resolve_plain(cidx: torch.Tensor, hit: torch.Tensor,
                  tax: Dict[str, torch.Tensor],
                  n_distinct: Optional[int] = None) -> torch.Tensor:
    """Plain torch K2: (R, W) int32 cidx + bool hit -> (R,) int32 original
    taxids (u32 bits)."""
    taxon_c = resolve_batch(cidx, hit, tax, n_distinct=n_distinct)
    return tax["tax_ids"][taxon_c]


def resolve(cidx: torch.Tensor, hit: torch.Tensor,
            tax: Dict[str, torch.Tensor],
            n_distinct: Optional[int] = None) -> torch.Tensor:
    """K2: the resolved original taxid of each read, (R,) int32 (u32 bits).
    CPU tensors take ``resolve_plain``; CUDA tensors the kernel, a warp a
    read for W <= 1024 and a block a read past it."""
    if cidx.device.type == "cpu":
        return resolve_plain(cidx, hit, tax, n_distinct)
    if cidx.device.type != "cuda":
        raise ValueError(f"resolve: no kernel for device {cidx.device}")
    dev = cidx.device
    R, W = cidx.shape
    kernels.check(cidx, "cidx", torch.int32, dev)
    kernels.check(hit, "hit", torch.bool, dev, (R, W))
    n = tax["tin"].shape[0]
    for name in ("tin", "tout", "depth", "parent", "tax_ids"):
        kernels.check(tax[name], name, torch.int32, dev, (n,))
    levels = tax["lift"].shape[0]
    kernels.check(tax["lift"], "lift", torch.int32, dev, (levels, n))
    taxon = torch.empty(R, dtype=torch.int32, device=dev)
    if R:
        kernels.launch(
            "bk_resolve", dev, cidx.data_ptr(), hit.data_ptr(), R, W,
            tax["tin"].data_ptr(), tax["tout"].data_ptr(),
            tax["depth"].data_ptr(), tax["parent"].data_ptr(),
            tax["lift"].data_ptr(), levels, n, tax["tax_ids"].data_ptr(),
            taxon.data_ptr(), int(dedup_rule(n_distinct, W)),
        )
        resolve.launches += 1
    return taxon


resolve.launches = 0
