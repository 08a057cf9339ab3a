"""Shared IVF list machinery (``raft_tpu.neighbors.ivf_common``
counterpart).

Every list lives in one dense padded tensor ``[n_lists, max_list, ...]``
with ``-1`` ids on empty slots — the layout a JAX-saved index carries.
:func:`assign_slots` caps list capacity (rows overflowing their nearest
list spill to the next candidate, then to any free slot) and
:func:`scatter_rows` packs rows into the padded layout. Every sort here is
stable, as ``jnp.argsort``'s, so both packages place rows in the same
slots.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from raft_tpu_torch.core.errors import fail
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.utils.math import round_up


def scan_mode_not_ported(algo: str) -> None:
    """Raise for a ``mode="scan"`` the port does not have yet."""
    fail("%s: mode='scan' (the dense scan over all lists) is not ported yet; use "
         "mode='fused', 'probe' or 'auto'", algo)


def coarse_from_dots(q_dot_c, centers, metric) -> torch.Tensor:
    """[nq, n_lists] coarse scores (smaller = better) from ``q @ centers.T``."""
    if metric == DistanceType.InnerProduct:
        return -q_dot_c
    c_norm = torch.sum(centers * centers, dim=1)
    return c_norm[None, :] - 2.0 * q_dot_c


def coarse_scores(centers, qf, metric) -> torch.Tensor:
    """[nq, n_lists] coarse scores, smaller = better. For cosine, ``qf``
    must already be unit-normalized."""
    return coarse_from_dots(qf @ centers.T, centers, metric)


def probed_from_coarse(coarse, n_probes: int) -> torch.Tensor:
    """``[nq, n_lists]`` bool: the ``n_probes`` best lists of each row."""
    nq, n_lists = coarse.shape
    if n_probes >= n_lists:
        return torch.ones((nq, n_lists), dtype=torch.bool, device=coarse.device)
    _, probes = select_k(coarse, n_probes, select_min=True)
    probed = torch.zeros((nq, n_lists), dtype=torch.bool, device=coarse.device)
    return probed.scatter_(1, probes.to(torch.int64), True)


def valid_slots(ids, filter_bits) -> torch.Tensor:
    """Slots that hold a row (id >= 0) kept by the prefilter's bits."""
    valid = ids >= 0
    if filter_bits is not None:
        cid = torch.clamp(ids, min=0).to(torch.int64)
        valid = valid & (((filter_bits[cid // 32] >> (cid % 32).to(torch.int32)) & 1) == 1)
    return valid


def probe_selection(centers, qf, n_probes: int, metric) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(coarse [nq, n_lists], probed [nq, n_lists] bool)``."""
    coarse = coarse_scores(centers, qf, metric)
    return coarse, probed_from_coarse(coarse, n_probes)


def topk_labels(ds_f32: torch.Tensor, centers: torch.Tensor, k: int = 4, block: int = 131072):
    """Per-row k nearest center ids ``[n, k]`` int32 (rankwise L2 via the
    norm trick), blocked so [block, n_lists] is the peak temporary."""
    n = ds_f32.shape[0]
    k = min(k, centers.shape[0])
    cn = torch.sum(centers * centers, dim=1)
    outs = []
    for s in range(0, n, block):
        score = 2.0 * (ds_f32[s : s + block] @ centers.T) - cn[None, :]
        outs.append(select_k(score, k, select_min=False)[1])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _rank_within(labels: torch.Tensor, active: torch.Tensor, big: int) -> torch.Tensor:
    """Stable rank of each active row within its label group."""
    n = labels.shape[0]
    key = torch.where(active, labels, torch.full_like(labels, big))
    order = torch.argsort(key, stable=True)
    sl = key[order]
    first = torch.ones((n,), dtype=torch.bool, device=labels.device)
    first[1:] = sl[1:] != sl[:-1]
    ar = torch.arange(n, device=labels.device)
    group_start = torch.cummax(torch.where(first, ar, torch.zeros_like(ar)), dim=0).values
    rank = torch.empty((n,), dtype=torch.int64, device=labels.device)
    rank[order] = ar - group_start
    return rank


def assign_slots(cand_labels: torch.Tensor, *, n_lists: int, max_list: int) -> torch.Tensor:
    """Flat destination slot per row in the padded layout (list-major):
    nearest candidate list while it has room, then the next candidate,
    then any free slot. Returns ``slot [n] int64``."""
    n, n_cand = cand_labels.shape
    dev = cand_labels.device
    total = n_lists * max_list
    cand = cand_labels.to(torch.int64)
    slot = torch.full((n,), total, dtype=torch.int64, device=dev)
    placed = torch.zeros((n,), dtype=torch.bool, device=dev)
    used = torch.zeros((n_lists + 1,), dtype=torch.int64, device=dev)
    for c in range(n_cand):
        lc = cand[:, c]
        rank = _rank_within(lc, ~placed, n_lists)
        fits = (~placed) & (used[lc] + rank < max_list)
        slot = torch.where(fits, lc * max_list + used[lc] + rank, slot)
        used.index_add_(0, torch.where(fits, lc, torch.full_like(lc, n_lists)),
                        torch.ones_like(lc))
        used[n_lists] = 0
        placed = placed | fits
    filled = torch.zeros((total + 1,), dtype=torch.int32, device=dev)
    filled[slot] = 1
    free_slots = torch.argsort(filled[:total], stable=True)
    rank3 = _rank_within(torch.zeros((n,), dtype=torch.int64, device=dev), ~placed, 1)
    return torch.where(~placed, free_slots[torch.clamp(rank3, 0, total - 1)], slot)


def choose_max_list(l1: torch.Tensor, n: int, n_lists: int, cap_factor: float) -> int:
    """The static ``max_list``; big lists are lane-aligned (a multiple of
    128) exactly as the JAX package does, because that is the layout a
    JAX-saved index carries."""
    max_count = int(torch.bincount(l1.to(torch.int64), minlength=n_lists).max())
    cap = max_count
    if cap_factor > 0:
        cap = min(cap, int(math.ceil(cap_factor * n / n_lists)))
    cap = max(cap, int(math.ceil(n / n_lists)))
    if cap >= 512:
        return round_up(cap, 128)
    return max(8, round_up(cap, 8))


def scatter_rows(rows: torch.Tensor, ids: torch.Tensor, slot: torch.Tensor, *,
                 n_lists: int, max_list: int):
    """Scatter rows + ids into the padded layout. Returns ``(data [n_lists,
    max_list, d], indices [n_lists, max_list] i32, sizes [n_lists] i32)``."""
    d = rows.shape[1]
    total = n_lists * max_list
    flat_data = torch.zeros((total + 1, d), dtype=rows.dtype, device=rows.device)
    flat_data[slot] = rows
    flat_ids = torch.full((total + 1,), -1, dtype=torch.int32, device=rows.device)
    flat_ids[slot] = ids.to(torch.int32)
    idx = flat_ids[:total].reshape(n_lists, max_list)
    sizes = torch.sum((idx >= 0).to(torch.int32), dim=1).to(torch.int32)
    return flat_data[:total].reshape(n_lists, max_list, d), idx, sizes


def pack_rows(rows, ids, cand_labels, n_lists: int, cap_factor: float):
    """assign_slots + scatter_rows with the max_list decision in between.
    Returns ``(data, indices, sizes, max_list)``."""
    max_list = choose_max_list(cand_labels[:, 0], rows.shape[0], n_lists, cap_factor)
    slot = assign_slots(cand_labels, n_lists=n_lists, max_list=max_list)
    data, idx, sizes = scatter_rows(rows, ids, slot, n_lists=n_lists, max_list=max_list)
    return data, idx, sizes, max_list
