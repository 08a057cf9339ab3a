"""Plain PyTorch reference of IVF search and of the IVF index layout.

It imports nothing of the program. It reads the program's index only to
judge it, or, where search can only follow the index (the lists a query
probes hold what the build put there), to follow it: the coarse probe,
the scan of each probed list, the PQ decode and the exact re-rank are
worked out here again from the raw rows and the index's tensors.

Distances are squared L2. ``precision`` is ``"f64"`` (the reference:
every product and sum in float64) or ``"tf32"`` (the control: the
operands of every product rounded to TF32's 10 mantissa bits, then
multiplied and summed in float32, as a TF32 tensor core does).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

#: the budget of one block's temporaries, in bytes
BLOCK_BYTES = 1 << 30


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa
    bits), ties away from zero."""
    xi = x.to(torch.float32).contiguous().view(torch.int32)
    return ((xi + 0x1000) & -0x2000).view(torch.float32)


def _cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f64":
        return x.to(torch.float64)
    if precision == "tf32":
        return round_tf32(x.to(torch.float32))
    raise ValueError(f"unknown precision {precision!r}")


def _norms(x: torch.Tensor, precision: str) -> torch.Tensor:
    dt = torch.float64 if precision == "f64" else torch.float32
    x = x.to(dt)
    return torch.sum(x * x, dim=-1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with TF32 off: float32 products stay float32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def sq_l2(q: torch.Tensor, x: torch.Tensor, precision: str = "f64") -> torch.Tensor:
    """``[nq, n]`` squared distances between the rows of ``q`` and ``x``
    (expanded form, products in ``precision``)."""
    qc, xc = _cast(q, precision), _cast(x, precision)
    d = _norms(q, precision)[:, None] + _norms(x, precision)[None, :] - 2.0 * _matmul(qc, xc.T)
    return torch.clamp(d, min=0.0)


def sq_l2_rows(q: torch.Tensor, xb: torch.Tensor, precision: str = "f64") -> torch.Tensor:
    """``[b, c]`` squared distances of each query ``q [b, d]`` to its own
    candidates ``xb [b, c, d]``."""
    qc, xc = _cast(q, precision), _cast(xb, precision)
    dot = _matmul(xc, qc[:, :, None])[:, :, 0]
    d = _norms(q, precision)[:, None] + _norms(xb, precision) - 2.0 * dot
    return torch.clamp(d, min=0.0)


def true_sq_l2(q: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Squared distances in float64 by differences, the judge's ruler:
    ``q [b, d]`` against ``xb [b, c, d]``."""
    diff = xb.to(torch.float64) - q.to(torch.float64)[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def probes(centers: torch.Tensor, q: torch.Tensor, n_probes: int, precision: str = "f64"):
    """The ``n_probes`` nearest lists of each query ``[nq, n_probes]``."""
    d = sq_l2(q, centers, precision)
    return torch.topk(d, n_probes, dim=1, largest=False).indices


def _blocks(nq: int, per_query_bytes: int):
    step = max(1, BLOCK_BYTES // max(1, per_query_bytes))
    for s in range(0, nq, step):
        yield s, min(nq, s + step)


def search(rows: torch.Tensor, q: torch.Tensor, index: Dict[str, torch.Tensor], *,
           n_probes: int, k: int, refine_ratio: int = 1,
           precision: str = "f64") -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF search as the configuration states it: each query of ``q``
    scans every row of its own ``n_probes`` nearest lists
    (:func:`scan_group`). Returns ``(distances, ids)`` of ``[nq, k]``."""
    p = torch.cat([probes(index["centers"], q[s:e], n_probes, precision)
                   for s, e in _blocks(q.shape[0], index["centers"].shape[0] * 8 * 3)])
    out = [scan_group(rows, q[j : j + 1], p[j], index, k=k, refine_ratio=refine_ratio,
                      precision=precision) for j in range(q.shape[0])]
    return torch.cat([d for d, _ in out]), torch.cat([i for _, i in out])


def _topk_valid(dist: torch.Tensor, ids: torch.Tensor, k: int):
    dist = torch.where(ids >= 0, dist, torch.full_like(dist, float("inf")))
    v, pos = torch.topk(dist, min(k, dist.shape[1]), dim=1, largest=False)
    return v, torch.gather(ids, 1, pos)


def _merge(acc, v, i, k: int):
    if acc is not None:
        v, i = torch.cat([acc[0], v], dim=1), torch.cat([acc[1], i], dim=1)
    return _topk_valid(v, i, k)


def scan_group(rows: torch.Tensor, q: torch.Tensor, lists: torch.Tensor,
               index: Dict[str, torch.Tensor], *, k: int, refine_ratio: int = 1,
               precision: str = "f64") -> Tuple[torch.Tensor, torch.Tensor]:
    """The best ``k`` of queries ``q`` over every row of ``lists``:
    IVF-Flat scores the rows exactly; IVF-PQ scores each row by its
    decoded code (``||R q - (R c_l + r)||^2``), keeps the best ``k *
    refine_ratio`` and re-ranks them exactly against ``rows``."""
    li = index["list_indices"]
    m = li.shape[1]
    pq = "codes" in index
    kk = k * refine_ratio if pq else k
    if pq:
        dt = torch.float64 if precision == "f64" else torch.float32
        rot = index["rotation"]
        q_s = _matmul(_cast(q, precision), _cast(rot, precision).T).to(dt)
        c_rot = _matmul(_cast(index["centers"], precision), _cast(rot, precision).T).to(dt)
        books = index["pq_centers"].to(dt)
    else:
        q_s = q
    per = max(1, (BLOCK_BYTES // 8) // max(1, m * (q.shape[0] + rows.shape[1] * 3)))
    acc = None
    for s in range(0, lists.shape[0], per):
        ls = lists[s : s + per]
        ids = li[ls].reshape(1, -1).to(torch.int64).expand(q.shape[0], -1)
        if pq:
            y = (pq_decode(index["codes"][ls], books)
                 + c_rot[ls][:, None, :]).reshape(-1, c_rot.shape[1])
            dist = sq_l2(q_s, y, precision)
        else:
            dist = sq_l2(q_s, rows[torch.clamp(ids[0], min=0)], precision)
        acc = _merge(acc, dist, ids, kk)
    v, cand = acc
    if not pq:
        return v, cand
    xb = rows[torch.clamp(cand, min=0)]
    return _topk_valid(sq_l2_rows(q, xb, precision), cand, k)


def pq_decode(codes: torch.Tensor, pq_centers: torch.Tensor) -> torch.Tensor:
    """Per-subspace codebooks ``[pq_dim, ksub, pq_len]`` at one code a
    byte ``[..., pq_dim]`` -> rotated residuals ``[..., pq_dim * pq_len]``."""
    sub = torch.arange(pq_centers.shape[0], device=codes.device)
    dec = pq_centers[sub, codes.to(torch.int64)]  # [..., pq_dim, pq_len]
    return dec.reshape(*codes.shape[:-1], -1)


def nearest_lists(rows: torch.Tensor, centers: torch.Tensor, given: torch.Tensor,
                  precision: str = "f64"):
    """Each row's nearest center by ``precision``'s products: ``(its id,
    the float64 distance to it, the float64 distance to the list ``given``
    holds the row in)``."""
    out_l, out_d, out_g = [], [], []
    for s, e in _blocks(rows.shape[0], centers.shape[0] * 8 * 3):
        d = sq_l2(rows[s:e], centers, precision)
        near = torch.argmin(d, dim=1)
        exact = d if precision == "f64" else sq_l2(rows[s:e], centers, "f64")
        out_l.append(near)
        out_d.append(torch.gather(exact, 1, near[:, None])[:, 0])
        out_g.append(torch.gather(exact, 1, given[s:e, None].to(torch.int64))[:, 0])
    return torch.cat(out_l), torch.cat(out_d), torch.cat(out_g)


def pq_code_dists(resid_rot: torch.Tensor, pq_centers: torch.Tensor,
                  precision: str = "f64") -> torch.Tensor:
    """The squared distance of every code of each subspace of rotated
    residuals ``[n, rot_dim]`` under per-subspace codebooks ``[pq_dim,
    ksub, pq_len]``: ``[n, pq_dim, ksub]``; float64 by differences, or
    the expanded form with ``precision``'s products."""
    pq_dim, ksub, pq_len = pq_centers.shape
    r = resid_rot.reshape(-1, pq_dim, pq_len)
    if precision == "f64":
        diff = r.to(torch.float64)[:, :, None, :] - pq_centers.to(torch.float64)[None]
        return torch.sum(diff * diff, dim=-1)
    dots = torch.einsum("npl,pkl->npk", _cast(r, precision), _cast(pq_centers, precision))
    return (_norms(r, precision)[:, :, None] - 2.0 * dots
            + _norms(pq_centers, precision)[None])


def lloyd(x: torch.Tensor, k: int, *, iters: int, seed: int) -> torch.Tensor:
    """Plain Lloyd's k-means in float64: ``k`` rows of ``x`` drawn from
    ``seed`` as the start, then ``iters`` rounds of assigning each row to
    its nearest centre and moving each centre to its rows' mean (a centre
    left without rows stays). Returns ``[k, d]`` float64 centres."""
    g = torch.Generator(device=x.device)
    g.manual_seed(int(seed))
    c = x[torch.randperm(x.shape[0], generator=g, device=x.device)[:k]].to(torch.float64)
    for _ in range(iters):
        sums = torch.zeros_like(c)
        counts = torch.zeros(k, dtype=torch.float64, device=x.device)
        for s, e in _blocks(x.shape[0], k * 8 * 3):
            xb = x[s:e].to(torch.float64)
            lab = torch.argmin(sq_l2(xb, c), dim=1)
            sums.index_add_(0, lab, xb)
            counts.index_add_(0, lab, torch.ones_like(lab, dtype=torch.float64))
        c = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], c)
    return c


def distortion(x: torch.Tensor, centers: torch.Tensor) -> float:
    """The mean squared distance of each row of ``x`` to its nearest
    centre (float64)."""
    total = 0.0
    for s, e in _blocks(x.shape[0], centers.shape[0] * 8 * 3):
        total += float(torch.min(sq_l2(x[s:e], centers), dim=1).values.sum())
    return total / max(1, x.shape[0])
