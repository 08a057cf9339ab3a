"""How ``correct`` is decided for the IVF cells: the numbers compared,
each against its limit in ``perfbench/limits/<workload>.json``.

Every answer of the window is judged on its own: its ids and distances
must be valid (``invalid``), and each distance must be the float64
distance of its id (``dist_err``, relative). A sample of the queries,
drawn from the seed, is searched again by the plain reference
(:mod:`perfbench.reference.ivf`) at float64, each query over its own
``n_probes`` nearest lists as the configuration states, and each
answer's slots are held against the reference's (``topk_miss``: the
share of slots farther than the reference's by more than rounding). The
same queries' answers are held against their exact k nearest rows
(``recall_miss``: one less recall@k). The index the program built is
judged on its own: every id held once (``ids_once``), the rows held as
given (``rows_equal``, IVF-Flat), each sampled row in its nearest list
where that list has room (``list_miss``) and coded by its nearest code
(``code_miss``, IVF-PQ), and its centres quantize the rows about as well
as a plain k-means does (``kmeans_excess``).

The control (``control=True``) puts the reference, with its products in
TF32, in the program's place and judges it the same way (every number
but ``kmeans_excess``, which judges the build and has a fault of its own,
``perfbench/faults.py``'s ``untrained``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.data import sub_seed
from perfbench.reference import ivf as ref

#: a gap within this share of the operands' squared norms is rounding
TIE = 1e-6
#: answer rows judged a block
ROW_BLOCK = 16384
#: rows whose list is judged, and rows whose codes are judged
LIST_ROWS, CODE_ROWS = 1 << 20, 1 << 16
#: rows the reference k-means trains on, a centre; and its rounds
KMEANS_ROWS_PER_LIST, KMEANS_ITERS = 256, 20
#: distances a block of the exact kNN
BLOCK_ELEMS = 1 << 26


def sample(n: int, m: int, seed: int, tag: str) -> np.ndarray:
    """``min(n, m)`` distinct indices below ``n``, drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, tag))
    return np.sort(rng.choice(n, size=min(n, m), replace=False))


class Judge:
    """The reference's rulers over one run's rows and index."""

    def __init__(self, config: dict, rows: torch.Tensor, view: Dict[str, torch.Tensor],
                 params: Optional[dict] = None):
        self.config = config
        self.params = {**config["search"], **(params or {})}
        self.rows = rows
        self.view = view
        self.k = int(config["k"])
        self.row_sq = float(torch.mean(torch.sum(rows.to(torch.float64) ** 2, dim=1)))

    # -- answers -----------------------------------------------------------

    def answers(self, queries: torch.Tensor, d: torch.Tensor, i: torch.Tensor):
        """``(invalid rows, max relative distance error, float64 distances of
        the answered ids [nq, k], validity [nq])`` of answers to ``queries``."""
        n = self.rows.shape[0]
        inv_total, err, out, ok_all = 0, 0.0, [], []
        for s in range(0, queries.shape[0], ROW_BLOCK):
            q, dd, ii = queries[s : s + ROW_BLOCK], d[s : s + ROW_BLOCK], i[s : s + ROW_BLOCK]
            ii = ii.to(torch.int64)
            in_range = ((ii >= 0) & (ii < n)).all(dim=1)
            srt = torch.sort(ii, dim=1).values
            unique = (srt[:, 1:] != srt[:, :-1]).all(dim=1)
            finite = torch.isfinite(dd).all(dim=1)
            ascending = (dd[:, 1:] >= dd[:, :-1]).all(dim=1)
            ok = in_range & unique & finite & ascending
            true = ref.true_sq_l2(q, self.rows[torch.clamp(ii, 0, n - 1)])
            true = torch.where(ok[:, None], true, torch.full_like(true, float("inf")))
            scale = torch.sum(q.to(torch.float64) ** 2, dim=1, keepdim=True) + self.row_sq
            rel = torch.abs(dd.to(torch.float64) - true) / torch.clamp(true, min=TIE * scale)
            rel = torch.where(ok[:, None], rel, torch.zeros_like(rel))
            inv_total += int((~ok).sum())
            err = max(err, float(rel.max()) if rel.numel() else 0.0)
            out.append(true)
            ok_all.append(ok)
        return inv_total, err, torch.cat(out), torch.cat(ok_all)

    def reference(self, q: torch.Tensor, precision: str = "f64"):
        """The reference's ``(distances, ids)`` of queries ``q``, each
        scanning its own ``n_probes`` nearest lists, as the configuration
        states (``precision``: the control's)."""
        p = self.params
        return ref.search(self.rows, q, self.view, n_probes=int(p["n_probes"]), k=self.k,
                          refine_ratio=int(p.get("refine_ratio", 1)), precision=precision)

    def exact(self, queries: torch.Tensor) -> torch.Tensor:
        """The ids of the exact k nearest rows of each query (float64)."""
        best_d, best_i = None, None
        step = max(1, (BLOCK_ELEMS // max(1, queries.shape[0])))
        for s in range(0, self.rows.shape[0], step):
            d = ref.sq_l2(queries, self.rows[s : s + step], "f64")
            i = torch.arange(s, s + d.shape[1], device=d.device).expand(d.shape[0], -1)
            if best_d is not None:
                d, i = torch.cat([best_d, d], dim=1), torch.cat([best_i, i], dim=1)
            v, pos = torch.topk(d, self.k, dim=1, largest=False)
            best_d, best_i = v, torch.gather(i, 1, pos)
        return best_i

    @staticmethod
    def recall_miss(ids: torch.Tensor, exact_ids: torch.Tensor) -> float:
        """One less recall@k of ``ids`` against ``exact_ids``."""
        hit = (ids.to(torch.int64)[:, :, None] == exact_ids[:, None, :]).any(dim=2)
        return 1.0 - float(hit.double().mean())

    def misses(self, queries: torch.Tensor, true_sorted: torch.Tensor,
               ref_d: torch.Tensor) -> int:
        """Slots whose answered distance lies beyond the reference's by
        more than rounding (both sorted best first, float64)."""
        scale = torch.sum(queries.to(torch.float64) ** 2, dim=1, keepdim=True) + self.row_sq
        return int((true_sorted > ref_d.to(torch.float64) + TIE * scale).sum())

    # -- the index ---------------------------------------------------------

    def slots(self) -> torch.Tensor:
        """The flat slot of every id (-1 where none)."""
        li = self.view["list_indices"].reshape(-1).to(torch.int64)
        where = torch.full((self.rows.shape[0],), -1, dtype=torch.int64, device=li.device)
        held = torch.nonzero(li >= 0)[:, 0]
        ids = li[held]
        ok = ids < self.rows.shape[0]
        where[ids[ok]] = held[ok]
        return where

    def ids_once(self) -> int:
        li = self.view["list_indices"].reshape(-1).to(torch.int64)
        ids = li[li >= 0]
        n = self.rows.shape[0]
        bad = int((ids >= n).sum())
        counts = torch.bincount(ids[ids < n], minlength=n)
        return bad + int((counts != 1).sum())

    def rows_equal(self) -> int:
        """Slots whose row differs from the given row in any bit."""
        ld = self.view["list_data"]
        li = self.view["list_indices"]
        bad = 0
        for l0 in range(0, li.shape[0], 64):
            ids = li[l0 : l0 + 64].to(torch.int64)
            held = ids >= 0
            got = ld[l0 : l0 + 64][held]
            want = self.rows[ids[held]].to(got.dtype)
            bad += int((got.view(torch.int32) != want.view(torch.int32)).any(dim=1).sum())
        return bad

    def list_miss(self, sample_ids: np.ndarray, where: torch.Tensor,
                  precision: Optional[str] = None) -> float:
        """Share of sampled rows outside their nearest list while it has
        room: the program's lists, or (``precision``) the reference's own
        choice at that precision."""
        ids = torch.from_numpy(sample_ids).to(self.rows.device)
        x = self.rows[ids]
        m = self.view["list_indices"].shape[1]
        given = torch.clamp(where[ids], min=0) // m
        if precision is not None:
            given = ref.nearest_lists(x, self.view["centers"], given, precision)[0]
        near, d_near, d_given = ref.nearest_lists(x, self.view["centers"], given, "f64")
        c_sq = torch.sum(self.view["centers"].to(torch.float64) ** 2, dim=1)
        scale = torch.sum(x.to(torch.float64) ** 2, dim=1) + c_sq[near]
        room = self.view["list_sizes"].to(torch.int64)[near] < m
        miss = (d_given > d_near + TIE * scale) & room
        return float(miss.double().mean()) if len(sample_ids) else 0.0

    def code_miss(self, sample_ids: np.ndarray, where: torch.Tensor,
                  precision: Optional[str] = None) -> float:
        """Share of sampled (row, subspace) codes that are not the nearest
        code of the row's rotated residual against its list's centre."""
        if not len(sample_ids):
            return 0.0
        v = self.view
        m = v["list_indices"].shape[1]
        books = v["pq_centers"].to(torch.float64)
        pq_dim, ksub, pq_len = books.shape
        c_sq = torch.max(torch.sum(books ** 2, dim=-1), dim=-1).values[None, :]
        rot = v["rotation"].to(torch.float64)
        flat_codes = v["codes"].reshape(-1, v["codes"].shape[-1])
        miss = 0
        step = max(1, ref.BLOCK_BYTES // (pq_dim * ksub * pq_len * 8 * 3))
        for s in range(0, len(sample_ids), step):
            ids = torch.from_numpy(sample_ids[s : s + step]).to(self.rows.device)
            slot = torch.clamp(where[ids], min=0)
            stored = flat_codes[slot].to(torch.int64)
            resid = ((self.rows[ids].to(torch.float64)
                      - v["centers"][slot // m].to(torch.float64)) @ rot.T)
            d = ref.pq_code_dists(resid, v["pq_centers"], "f64")
            if precision is not None:
                stored = torch.argmin(ref.pq_code_dists(resid.to(torch.float32),
                                                        v["pq_centers"], precision), dim=-1)
            best = torch.min(d, dim=-1).values
            got = torch.gather(d, 2, stored[:, :, None])[:, :, 0]
            r_sq = torch.sum(resid.reshape(-1, pq_dim, pq_len) ** 2, dim=-1)
            miss += int((got > best + TIE * (r_sq + c_sq)).sum())
        return miss / (len(sample_ids) * pq_dim)

    def kmeans_excess(self, sample_ids: np.ndarray, seed: int) -> float:
        """How much worse than a plain k-means the index's centres quantize
        the sampled rows: the mean squared distance of each row to the
        centre of the list that holds it, over that of a plain Lloyd's
        k-means (:func:`perfbench.reference.ivf.lloyd`, trained on rows
        drawn from the seed) to its nearest centre, less 1 (below 0 where
        the index's centres do better)."""
        x = self.rows[torch.from_numpy(sample_ids).to(self.rows.device)]
        m = self.view["list_indices"].shape[1]
        held = torch.clamp(self.slots()[torch.from_numpy(sample_ids).to(x.device)], min=0) // m
        diff = x.to(torch.float64) - self.view["centers"][held].to(torch.float64)
        program = float(torch.sum(diff * diff)) / max(1, x.shape[0])
        k = self.view["centers"].shape[0]
        train = sample(self.rows.shape[0], k * KMEANS_ROWS_PER_LIST, seed, "check.kmeans")
        centers = ref.lloyd(self.rows[torch.from_numpy(train).to(x.device)], k,
                            iters=KMEANS_ITERS, seed=sub_seed(seed, "check.kmeans.start"))
        return program / ref.distortion(x, centers) - 1.0

    def index_numbers(self, seed: int, precision: Optional[str] = None) -> Dict[str, float]:
        """The index's numbers (``precision``: the control's choices), over
        rows drawn from the seed."""
        where = self.slots()
        n = self.rows.shape[0]
        out: Dict[str, float] = {}
        if precision is None:
            out["ids_once"] = self.ids_once()
            if "list_data" in self.view:
                out["rows_equal"] = self.rows_equal()
        rows = sample(n, LIST_ROWS, seed, "check.rows")
        out["list_miss"] = self.list_miss(rows, where, precision)
        if precision is None:
            out["kmeans_excess"] = self.kmeans_excess(rows, seed)
        if "codes" in self.view:
            out["code_miss"] = self.code_miss(sample(n, CODE_ROWS, seed, "check.codes"), where,
                                              precision)
        return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """``(every reading within its limit, a line a number)``; a number
    with no reading fails."""
    lines, ok = [], True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and v <= limit
        ok &= good
        lines.append(f"check {name} = {v!r} limit {limit!r} {'ok' if good else 'FAIL'}")
    return ok, lines
