"""IVF-PQ index (``raft_tpu.neighbors.ivf_pq`` counterpart).

Codes live in one dense padded tensor ``codes [n_lists, max_list, bpr]``
uint8 beside ``list_indices [n_lists, max_list]`` (int32, -1 = empty),
``list_sizes`` and ``rot_sqnorms`` (the squared norm of each decoded
rotated vector) — the layout and the serialized form (kind ``ivf_pq``,
version 4) of the JAX package, so an index saved by either package loads
in the other.

Code families (``pq_kind``): ``"kmeans"`` (one ``2^pq_bits``-entry
codebook per subspace or per cluster; widths 3-7 bit-packed when the row
bitstream is byte-aligned), ``"nibble"`` (additive nibble pairs, subspace
j quantized by ``A[j][hi] + B[j][lo]``; ``pq_centers`` holds the
materialized 256-entry sum grid) and ``"rabitq"`` (one sign bit per
rotated residual dimension plus the per-slot estimator terms C1, in
``rot_sqnorms``, and g, in ``corrections``). ``"auto"`` is rabitq at
``pq_bits=1``, nibble at ``pq_bits=8`` with per-subspace books, else
kmeans.

Search modes:

* ``"fused"`` — the fused probed-list scan: kernel B2
  (:func:`raft_tpu_torch.ops.pq_scan.ivf_pq_fused_search`) for PQ codes,
  kernel B3 (:func:`raft_tpu_torch.ops.rabitq_scan.ivf_rabitq_fused_search`)
  for RaBitQ, both with a bf16 LUT or f32 estimator and an exact top-k.
* ``"scan"`` — the dense decode-and-score scan (:func:`pq_scan_core`):
  every list chunk decoded from the codebooks and scored by one matmul,
  unprobed lists and empty slots masked, an exact top-k; the per-shard
  core of :func:`raft_tpu_torch.parallel.sharded_ivf_pq_lists_search`.
  For RaBitQ (:func:`rabitq_scan_core`) each chunk's sign bits and one FP32
  product give the estimator.
* ``"probe"`` — per-probe f32 LUT gather + running merge.
* ``"auto"`` — from 128 queries, fused on a CUDA index when eligible and
  scan on any other device; else probe.

With ``dataset=`` and ``refine_ratio > 1`` (the default 8) search keeps
``k * refine_ratio`` candidates and re-ranks them with exact distances.

Supported metrics: L2Expanded, L2SqrtExpanded, InnerProduct.
"""
from __future__ import annotations

import dataclasses
import io
import threading
import warnings
from typing import BinaryIO, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans import make_generator, segment_sum
from raft_tpu_torch.cluster.kmeans_balanced import BalancedKMeansParams
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.neighbors import ivf_common
from raft_tpu_torch.neighbors.ivf_flat import _batched
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.ops.fused_1nn import min_cluster_and_distance
from raft_tpu_torch.ops.ivf_scan import spatial_center_rank
from raft_tpu_torch.ops.pq_scan import group_tables, ivf_pq_fused_search
from raft_tpu_torch.ops.rabitq_scan import ivf_rabitq_fused_search, sign_bits
from raft_tpu_torch.ops.select_k import select_k, worst_value
from raft_tpu_torch.robust import faults
from raft_tpu_torch.utils.math import round_up

_SUPPORTED = (
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.InnerProduct,
)

PER_SUBSPACE = "per_subspace"
PER_CLUSTER = "per_cluster"


def _default_pq_dim(dim: int) -> int:
    """Reference heuristic (``calculate_pq_dim``): halve large dims, round
    down to a multiple of 32, else the nearest power of two below."""
    d = dim // 2 if dim >= 128 else dim
    r = (d // 32) * 32
    if r > 0:
        return r
    r = 1
    while r * 2 <= d:
        r *= 2
    return r


@dataclasses.dataclass
class IvfPqIndexParams:
    """``ivf_pq::index_params`` analog; every field and default of the JAX
    package. ``pq_kind``: ``"auto"`` | ``"kmeans"`` | ``"nibble"`` |
    ``"rabitq"`` (see the module docstring). ``list_cap_factor`` 0 = no
    capacity cap (a spilled row's residual would be taken against its
    second-nearest center)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8
    pq_dim: int = 0  # 0 = auto (calculate_pq_dim)
    codebook_kind: str = PER_SUBSPACE
    force_random_rotation: bool = False
    seed: int = 0
    list_cap_factor: float = 0.0
    pq_kind: str = "auto"


@dataclasses.dataclass
class IvfPqSearchParams:
    """``ivf_pq::search_params`` analog; every field and default of the
    JAX package. ``refine_ratio`` re-ranks ``k * refine_ratio`` candidates
    exactly when :func:`search` gets ``dataset=``. ``lut_dtype``: None =
    f32 on the probe path and bf16 on the fused path; ``torch.float32``
    makes ``"auto"`` take the probe path; another dtype rounds the probe
    LUT to it. In the port ``fused_merge`` does not change the result (the
    kernels keep the exact top-k); ``fused_extract_every`` and
    ``fused_decode_cols`` tune the TPU kernel only."""

    n_probes: int = 30
    refine_ratio: int = 8
    lut_dtype: Optional[torch.dtype] = None
    fused_qt: int = 128
    fused_probe_factor: int = 32
    fused_group: int = 8
    fused_merge: str = "bank8"
    fused_extract_every: int = 0
    fused_decode_cols: int = 2048


@dataclasses.dataclass
class IvfPqIndex:
    """Product-quantized inverted-file index."""

    centers: torch.Tensor  # [n_lists, d] f32 raw coarse centers
    centers_rot: torch.Tensor  # [n_lists, rot_dim] f32 rotated centers
    rotation: torch.Tensor  # [rot_dim, d] f32 orthonormal rows
    pq_centers: torch.Tensor  # per_subspace [pq_dim, ksub, pq_len]; per_cluster [n_lists, ksub, pq_len]
    codes: torch.Tensor  # [n_lists, max_list, bpr] u8
    list_indices: torch.Tensor  # [n_lists, max_list] i32, -1 = empty
    list_sizes: torch.Tensor  # [n_lists] i32
    rot_sqnorms: torch.Tensor  # [n_lists, max_list] f32 (rabitq: the estimator constant C1)
    metric: DistanceType
    codebook_kind: str
    pq_bits: int
    size: int
    list_cap_factor: float = 0.0
    additive: bool = False  # nibble-pair codebooks
    packed: bool = False  # sub-byte codes bit-packed
    center_rank: Optional[torch.Tensor] = None
    rabitq: bool = False
    corrections: Optional[torch.Tensor] = None  # [n_lists, max_list] f32 rabitq g

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def pq_dim(self) -> int:
        return self.codes.shape[2] * 8 // self.pq_bits if self.packed else self.codes.shape[2]

    @property
    def pq_len(self) -> int:
        return self.pq_centers.shape[-1]

    @property
    def ksub(self) -> int:
        return self.pq_centers.shape[-2]

    @property
    def max_list(self) -> int:
        return self.codes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def codes_unpacked(self) -> torch.Tensor:
        """``[n_lists, max_list, pq_dim]`` u8, one code per byte."""
        if not self.packed:
            return self.codes
        return unpack_codes_bits(self.codes, self.pq_bits, self.pq_dim)


# ---------------------------------------------------------------------------
# code packing
# ---------------------------------------------------------------------------


def pack_codes(codes) -> torch.Tensor:
    """Pack 4-bit codes pairwise: byte b = code[2b] | (code[2b+1] << 4)."""
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_codes(packed) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: ``[..., bpr]`` -> ``[..., 2 * bpr]`` u8."""
    lo = packed & 15
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1).to(torch.uint8)


def pack_codes_bits(codes, bits: int) -> torch.Tensor:
    """Bit-pack ``bits``-wide codes as a little-endian bitstream per row:
    code j occupies bits ``[j * bits, (j + 1) * bits)``, bit t of byte s is
    bit ``8 s + t``. Needs ``pq_dim * bits % 8 == 0``; ``bits=4`` is
    :func:`pack_codes`'s pairwise layout."""
    if bits == 4:
        return pack_codes(codes)
    pq_dim = codes.shape[-1]
    expects(pq_dim * bits % 8 == 0, "pq_dim*bits must be byte-aligned to pack")
    bpr = pq_dim * bits // 8
    c = codes.to(torch.int32)
    bit = (c[..., None] >> torch.arange(bits, dtype=torch.int32, device=c.device)) & 1
    by = bit.reshape(*codes.shape[:-1], bpr, 8)
    w = 1 << torch.arange(8, dtype=torch.int32, device=c.device)
    return torch.sum(by * w, dim=-1).to(torch.uint8)


def unpack_codes_bits(packed, bits: int, pq_dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_bits`."""
    if bits == 4:
        return unpack_codes(packed)
    p = packed.to(torch.int32)
    bit = (p[..., None] >> torch.arange(8, dtype=torch.int32, device=p.device)) & 1
    co = bit.reshape(*packed.shape[:-1], pq_dim, bits)
    w = 1 << torch.arange(bits, dtype=torch.int32, device=p.device)
    return torch.sum(co * w, dim=-1).to(torch.uint8)


def nibble_books(pq_centers) -> torch.Tensor:
    """The fused scan's nibble codebooks ``[pq_dim, 32, pq_len]`` from the
    materialized grid ``pq_centers[j, hi*16+lo] = A[hi] + B[lo]``:
    ``A'[hi] = grid[hi*16]``, ``B'[lo] = grid[lo] - grid[0]``."""
    a = pq_centers[:, 0::16, :]
    b = pq_centers[:, 0:16, :] - pq_centers[:, 0:1, :]
    return torch.cat([a, b], dim=1)


def fused_code_layout(index: IvfPqIndex) -> Tuple[str, int]:
    """``(code_mode, ksub)`` the fused kernel reads this index with."""
    if index.additive:
        return "nib8", 16
    if index.packed and index.pq_bits == 4:
        return "p4", 16
    if index.packed:
        return f"b{index.pq_bits}", index.ksub
    return "u8", index.ksub


# ---------------------------------------------------------------------------
# build helpers
# ---------------------------------------------------------------------------


def _make_rotation(gen: torch.Generator, rot_dim: int, dim: int, force: bool) -> torch.Tensor:
    """Orthonormal ``[rot_dim, dim]`` transform: identity when square and
    not forced, else the Q factor of a Gaussian matrix drawn from ``gen``."""
    if not force and rot_dim == dim:
        return torch.eye(dim, dtype=torch.float32, device=gen.device)
    n = max(rot_dim, dim)
    g = torch.randn((n, n), generator=gen, device=gen.device, dtype=torch.float32)
    q, _ = torch.linalg.qr(g)
    return q[:rot_dim, :dim].contiguous()


def _nearest_batched(X, centers, block_elems: int = 1 << 26) -> torch.Tensor:
    """Per batch, the nearest center of each row: ``X [B, n, d]``,
    ``centers [B, k, d]`` -> ``[B, n]`` int64 (first index on ties), in row
    blocks of at most ``block_elems`` distances."""
    B, n, _ = X.shape
    k = centers.shape[1]
    xn = torch.sum(X * X, dim=2)
    cn = torch.sum(centers * centers, dim=2)
    blk = max(1, block_elems // max(1, B * k))
    out = []
    for s in range(0, n, blk):
        d2 = (xn[:, s : s + blk, None] - 2.0 * torch.bmm(X[:, s : s + blk], centers.transpose(1, 2))
              + cn[:, None, :])
        out.append(torch.argmin(d2, dim=2))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def _segment_sums(X, labels, weights, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per batch, weighted sums and weights of the rows of each label:
    ``X [B, n, d]``, ``labels [B, n]``, ``weights [B, n]`` ->
    ``([B, k, d], [B, k])``."""
    sums = segment_sum(X * weights[:, :, None], labels, k, batched=True)
    return sums, segment_sum(weights, labels, k, batched=True)


def _batched_lloyd(X, mask, init, *, k: int, n_iters: int) -> torch.Tensor:
    """Masked Lloyd on a batch of problems: ``X [B, n, d]``, 0/1 ``mask
    [B, n]``, ``init [B, k, d]`` -> centers ``[B, k, d]`` (the JAX
    package's vmap written out as a batch dimension)."""
    centers = init.to(torch.float32)
    for _ in range(n_iters):
        labels = _nearest_batched(X, centers)
        sums, counts = _segment_sums(X, labels, mask, k)
        means = sums / torch.clamp(counts[:, :, None], min=1e-9)
        centers = torch.where(counts[:, :, None] > 0, means, centers)
    return centers


def _rotated_residuals(X, labels, centers, rotation, pq_dim: int) -> torch.Tensor:
    """``R (x - c[label])`` as ``[n, pq_dim, pq_len]``."""
    rr = (X - centers[labels.to(torch.int64)]) @ rotation.T
    return rr.reshape(X.shape[0], pq_dim, -1)


def _train_nibble_books(t_resid, gen: torch.Generator, n_iters: int) -> torch.Tensor:
    """Additive nibble codebooks: A = 16-center Lloyd on the residuals,
    B = 16-center Lloyd on the second-level residuals, then two rounds of
    joint re-encode / re-fit. Returns the materialized 256-entry sum grid
    ``[pq_dim, 256, pq_len]``."""
    pq_dim = t_resid.shape[1]
    nt = t_resid.shape[0]
    Xs = t_resid.permute(1, 0, 2).contiguous()  # [pq_dim, nt, pq_len]
    pq_len = Xs.shape[2]
    ones = torch.ones((pq_dim, nt), dtype=torch.float32, device=Xs.device)

    def seed_init(X):
        idx = torch.randperm(nt, generator=gen, device=gen.device)[: min(16, nt)].to(X.device)
        init = X[:, idx, :]
        if init.shape[1] < 16:
            reps = -(-16 // init.shape[1])
            init = init.repeat(1, reps, 1)[:, :16, :]
        return init

    def take(books, labels):  # [pq_dim, 16, pq_len] at [pq_dim, nt] -> [pq_dim, nt, pq_len]
        return torch.gather(books, 1, labels[:, :, None].expand(-1, -1, pq_len))

    def refit(X, labels, old):
        sums, counts = _segment_sums(X, labels, ones, 16)
        means = sums / torch.clamp(counts[:, :, None], min=1e-9)
        return torch.where(counts[:, :, None] > 0, means, old)

    A = _batched_lloyd(Xs, ones, seed_init(Xs), k=16, n_iters=n_iters)
    hi = _nearest_batched(Xs, A)
    R2 = Xs - take(A, hi)
    B = _batched_lloyd(R2, ones, seed_init(R2), k=16, n_iters=n_iters)
    for _ in range(2):  # coordinate descent on (A, B)
        lo = _nearest_batched(Xs - take(A, hi), B)
        A = refit(Xs - take(B, lo), hi, A)
        hi = _nearest_batched(Xs - take(B, lo), A)
        B = refit(Xs - take(A, hi), lo, B)
    grid = A[:, :, None, :] + B[:, None, :, :]  # [pq_dim, 16, 16, pq_len]
    return grid.reshape(pq_dim, 256, -1)


def _train_per_cluster(t_resid, t_labels, n_lists: int, ksub: int, seed: int, n_iters: int):
    """Per-cluster codebooks: each cluster's residual subvectors (all
    subspaces pooled) padded to one budget, a seeded subsample where a
    cluster exceeds it, trained in batched chunks (``ivf_pq.py:779-829``)."""
    nt, pq_dim, pq_len = t_resid.shape
    dev = t_resid.device
    lab_np = t_labels.cpu().numpy()
    flat = t_resid.cpu().numpy().reshape(nt * pq_dim, pq_len)
    row_cluster = np.repeat(lab_np, pq_dim)
    order = np.argsort(row_cluster, kind="stable")
    counts = np.bincount(row_cluster, minlength=n_lists)
    budget = max(ksub, min(int(counts.max()) if n_lists else ksub, 4096))
    sub_rng = np.random.default_rng(seed + 0x5EED)
    Xc = np.zeros((n_lists, budget, pq_len), np.float32)
    Mc = np.zeros((n_lists, budget), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for c in range(n_lists):
        cnt = int(counts[c])
        take = min(cnt, budget)
        sel = order[starts[c] : starts[c] + cnt]
        if cnt > budget:
            sel = sel[sub_rng.choice(cnt, size=budget, replace=False)]
        rows = flat[sel]
        Xc[c, :take] = rows
        Mc[c, :take] = 1.0
        if 0 < take < ksub:  # at least ksub seed rows
            Xc[c, take:ksub] = rows[np.arange(ksub - take) % take]
    Xc_t = torch.from_numpy(Xc).to(dev)
    Mc_t = torch.from_numpy(Mc).to(dev)
    chunk = max(1, 128 // max(1, budget // 1024))
    parts = [
        _batched_lloyd(Xc_t[s : s + chunk], Mc_t[s : s + chunk], Xc_t[s : s + chunk, :ksub],
                       k=ksub, n_iters=n_iters)
        for s in range(0, n_lists, chunk)
    ]
    return torch.cat(parts, dim=0)


def _encode_chunk(resid_rot, labels, pq_centers, per_cluster: bool) -> torch.Tensor:
    """Nearest sub-center per subspace: ``[c, pq_dim, pq_len]`` -> ``[c,
    pq_dim]`` u8 (first index on ties)."""
    if per_cluster:
        pqc = pq_centers[labels.to(torch.int64)]  # [c, ksub, pq_len]
        dots = torch.einsum("npl,nkl->npk", resid_rot, pqc)
        cn = torch.sum(pqc * pqc, dim=-1)[:, None, :]
    else:
        dots = torch.einsum("npl,pkl->npk", resid_rot, pq_centers)
        cn = torch.sum(pq_centers * pq_centers, dim=-1)[None, :, :]
    return torch.argmin(cn - 2.0 * dots, dim=-1).to(torch.uint8)


def _encode_all(ds_f32, labels, centers, rotation, pq_centers, pq_dim: int, per_cluster: bool,
                chunk: int = 16384) -> torch.Tensor:
    """Encode every row against its final list's center, in row chunks."""
    outs = [
        _encode_chunk(_rotated_residuals(ds_f32[s : s + chunk], labels[s : s + chunk], centers,
                                         rotation, pq_dim),
                      labels[s : s + chunk], pq_centers, per_cluster)
        for s in range(0, ds_f32.shape[0], chunk)
    ]
    if not outs:
        return torch.zeros((0, pq_dim), dtype=torch.uint8, device=ds_f32.device)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _sqnorms_for(codes, centers_rot, pq_centers, per_cluster: bool,
                 chunk_rows: int = 262144) -> torch.Tensor:
    """``||c_rot[l] + decode(code)||^2`` per slot ``[n_lists, max_list]``
    from one-code-per-byte ``codes``, in chunks of whole lists."""
    n_lists, M, pq_dim = codes.shape
    rot_dim = centers_rot.shape[1]
    dev = codes.device
    sub = torch.arange(pq_dim, device=dev)[None, None, :]
    out = []
    step = max(1, chunk_rows // max(M, 1))
    for s in range(0, n_lists, step):
        cod = codes[s : s + step].to(torch.int64)  # [g, M, pq_dim]
        if per_cluster:
            lists = torch.arange(cod.shape[0], device=dev)[:, None, None]
            resid = pq_centers[s : s + step][lists, cod]  # [g, M, pq_dim, pq_len]
        else:
            resid = pq_centers[sub, cod]
        dec = resid.reshape(cod.shape[0], M, rot_dim) + centers_rot[s : s + step, None, :]
        out.append(torch.sum(dec * dec, dim=-1))
    return torch.cat(out, dim=0) if out else torch.zeros((0, M), device=dev)


def _rabitq_encode_chunk(X, labels, centers, rotation, centers_rot, metric: DistanceType):
    """RaBitQ-encode rows against their lists' centers (``ivf_pq.py:547-592``):
    the D sign bits of ``r = R(x - c_l)`` and the per-row estimator terms

        g_L2 = 4||r|| / (sqrt(D) <x̄, o>)       g_IP = g_L2 / 2
        C1_L2 = ||c_rot||^2 + ||r||^2 + g_L2 (b.c_rot - sum(c_rot) / 2)
        C1_IP = 0

    with ``<x̄, o> = ||r||_1 / (sqrt(D) ||r||_2)``. Returns ``(packed bits
    [c, D/8] u8, aux [c, 2] f32 = [C1, g])``."""
    lab = labels.to(torch.int64)
    rr = (X - centers[lab]) @ rotation.T
    D = rr.shape[1]
    r2 = torch.sum(rr * rr, dim=1)
    r = torch.sqrt(r2)
    sd = torch.rsqrt(torch.tensor(float(D), dtype=torch.float32, device=rr.device))
    ood = sd * torch.sum(torch.abs(rr), dim=1) / torch.clamp(r, min=1e-30)
    g = torch.where(r > 0, 4.0 * r * sd / torch.clamp(ood, min=1e-12), torch.zeros_like(r))
    if metric == DistanceType.InnerProduct:
        g = 0.5 * g
    signs = (rr > 0).to(torch.uint8)
    crot = centers_rot[lab]
    if metric == DistanceType.InnerProduct:
        c1 = torch.zeros_like(g)
    else:
        bdotc = torch.sum(torch.where(rr > 0, crot, torch.zeros_like(crot)), dim=1)
        c1 = torch.sum(crot * crot, dim=1) + r2 + g * (bdotc - 0.5 * torch.sum(crot, dim=1))
    return pack_codes_bits(signs, 1), torch.stack([c1, g], dim=1)


def _rabitq_encode_all(ds_f32, labels, centers, rotation, centers_rot, metric, chunk: int = 65536):
    """Chunked :func:`_rabitq_encode_chunk` over all rows."""
    D = rotation.shape[0]
    codes, auxs = [], []
    for s in range(0, ds_f32.shape[0], chunk):
        cod, aux = _rabitq_encode_chunk(ds_f32[s : s + chunk], labels[s : s + chunk], centers,
                                        rotation, centers_rot, metric)
        codes.append(cod)
        auxs.append(aux)
    if not codes:
        dev = ds_f32.device
        return (torch.zeros((0, D // 8), dtype=torch.uint8, device=dev),
                torch.zeros((0, 2), dtype=torch.float32, device=dev))
    return torch.cat(codes, dim=0), torch.cat(auxs, dim=0)


def _resolve_kind(params: IvfPqIndexParams) -> str:
    """``pq_kind`` with ``"auto"`` resolved (through
    :func:`raft_tpu_torch.plan.plan_pq_kind` when the planner's gate is on),
    after the JAX package's checks."""
    expects(params.codebook_kind in (PER_SUBSPACE, PER_CLUSTER), "bad codebook_kind")
    expects(params.pq_kind in ("auto", "kmeans", "nibble", "rabitq"),
            "pq_kind must be auto|kmeans|nibble|rabitq")
    kind = params.pq_kind
    if kind == "auto":
        from raft_tpu_torch import plan

        if plan.is_enabled():
            kind = plan.plan_pq_kind(params.pq_bits, params.codebook_kind == PER_SUBSPACE,
                                     pq_dim=int(params.pq_dim or 16)).choice
        elif params.pq_bits == 1:
            kind = "rabitq"
        elif params.pq_bits == 8 and params.codebook_kind == PER_SUBSPACE:
            kind = "nibble"
        else:
            kind = "kmeans"
    if kind == "rabitq":
        expects(params.pq_bits in (1, 8),
                "pq_kind='rabitq' is 1 bit/dim; pq_bits=%d conflicts", params.pq_bits)
    else:
        expects(3 <= params.pq_bits <= 8, "pq_bits must be in [3, 8], got %d", params.pq_bits)
    if kind == "nibble":
        expects(params.pq_bits == 8 and params.codebook_kind == PER_SUBSPACE,
                "pq_kind='nibble' requires pq_bits=8 and per_subspace codebooks")
    return kind


def build(
    dataset,
    params: Optional[IvfPqIndexParams] = None,
    res: Optional[Resources] = None,
    **kwargs,
) -> IvfPqIndex:
    """Train the coarse quantizer (balanced k-means, lists ordered by the
    PCA-bisection rank of their centers), the rotation and the codebooks,
    then encode and pack the dataset (``ivf_pq::build``). The trainset is
    numpy ``default_rng(seed)``'s sample, as in the JAX package; the
    rotation and codebook seeds are drawn from a ``torch.Generator``."""
    res = ensure_resources(res)
    if params is None:
        params = IvfPqIndexParams(**kwargs)
    metric = resolve_metric(params.metric)
    expects(metric in _SUPPORTED, "IVF-PQ does not support metric %s", metric)
    kind = _resolve_kind(params)
    dataset = ser.as_tensor(dataset, res.device)
    expects(dataset.ndim == 2, "dataset must be [n_rows, dim]")
    n, d = dataset.shape
    n_lists = min(params.n_lists, n)
    if kind == "rabitq":
        pq_dim = rot_dim = round_up(d, 8)
    else:
        pq_dim = params.pq_dim or _default_pq_dim(d)
        expects(pq_dim <= d, "pq_dim=%d larger than dim=%d", pq_dim, d)
        rot_dim = round_up(d, pq_dim)
    ksub = 1 << params.pq_bits

    ds_f32 = dataset.to(torch.float32)
    train_n = max(n_lists, int(n * params.kmeans_trainset_fraction))
    trainset = ds_f32
    if train_n < n:
        rng = np.random.default_rng(params.seed)
        trainset = ds_f32[torch.from_numpy(rng.permutation(n)[:train_n]).to(res.device)]
    centers = kmeans_balanced.fit(
        trainset,
        BalancedKMeansParams(n_clusters=n_lists, n_iters=params.kmeans_n_iters,
                             metric=DistanceType.L2Expanded, seed=params.seed),
    )
    rank = spatial_center_rank(centers.cpu().numpy())
    centers = centers[torch.from_numpy(np.argsort(rank)).to(res.device)]

    gen = make_generator(params.seed, res.device)
    # RaBitQ's estimator is unbiased only under a random rotation
    rotation = _make_rotation(gen, rot_dim, d, params.force_random_rotation or kind == "rabitq")
    if kind == "rabitq":
        pq_centers = torch.zeros((1, 1, 1), dtype=torch.float32, device=res.device)
    else:
        t_labels, _ = min_cluster_and_distance(trainset, centers, metric=DistanceType.L2Expanded)
        t_resid = _rotated_residuals(trainset, t_labels, centers, rotation, pq_dim)
        nt = t_resid.shape[0]
        if kind == "nibble":
            pq_centers = _train_nibble_books(t_resid, gen, params.kmeans_n_iters)
        elif params.codebook_kind == PER_SUBSPACE:
            Xs = t_resid.permute(1, 0, 2).contiguous()  # [pq_dim, nt, pq_len]
            idx = torch.randperm(nt, generator=gen, device=gen.device)[: min(ksub, nt)]
            init = Xs[:, idx.to(Xs.device), :]
            if init.shape[1] < ksub:  # tiny trainset: tile the seeds
                init = init.repeat(1, -(-ksub // init.shape[1]), 1)[:, :ksub, :]
            mask = torch.ones((pq_dim, nt), dtype=torch.float32, device=Xs.device)
            pq_centers = _batched_lloyd(Xs, mask, init, k=ksub, n_iters=params.kmeans_n_iters)
        else:
            pq_centers = _train_per_cluster(t_resid, t_labels, n_lists, ksub, params.seed,
                                            params.kmeans_n_iters)
    return build_with_quantizers(
        dataset, centers, rotation, pq_centers,
        dataclasses.replace(params, metric=metric, pq_kind=kind), res,
    )


def build_with_quantizers(dataset, centers, rotation, pq_centers,
                          params: Optional[IvfPqIndexParams] = None,
                          res: Optional[Resources] = None, **kwargs) -> IvfPqIndex:
    """Encode and pack the dataset with given quantizers — the second half
    of :func:`build`: capacity-capped list assignment, encoding against each
    row's final list, the scatter into the padded layout, decoded squared
    norms and bit packing. ``centers`` must already be in spatial order (as
    a built index's are); ``center_rank`` is the identity. For RaBitQ
    (``pq_kind="rabitq"`` or ``pq_bits=1``) ``pq_centers`` is a placeholder
    and the rows get sign codes and estimator terms."""
    res = ensure_resources(res)
    if params is None:
        params = IvfPqIndexParams(**kwargs)
    metric = resolve_metric(params.metric)
    kind = _resolve_kind(params)
    dataset = ser.as_tensor(dataset, res.device)
    centers = ser.as_tensor(centers, res.device).to(torch.float32)
    rotation = ser.as_tensor(rotation, res.device).to(torch.float32)
    pq_centers = ser.as_tensor(pq_centers, res.device).to(torch.float32)
    n = dataset.shape[0]
    n_lists = centers.shape[0]
    ds_f32 = dataset.to(torch.float32)
    centers_rot = centers @ rotation.T
    per_cluster = params.codebook_kind == PER_CLUSTER

    cand = ivf_common.topk_labels(ds_f32, centers, k=8)
    max_list = ivf_common.choose_max_list(cand[:, 0], n, n_lists, params.list_cap_factor)
    slot = ivf_common.assign_slots(cand, n_lists=n_lists, max_list=max_list)
    final_labels = slot // max_list
    ids = torch.arange(n, dtype=torch.int32, device=res.device)
    common = dict(centers=centers, centers_rot=centers_rot, rotation=rotation, metric=metric,
                  codebook_kind=params.codebook_kind, size=n,
                  list_cap_factor=params.list_cap_factor,
                  center_rank=torch.arange(n_lists, dtype=torch.int32, device=res.device))
    if kind == "rabitq":
        codes_dev, aux_dev = _rabitq_encode_all(ds_f32, final_labels, centers, rotation,
                                                centers_rot, metric)
        codes, list_indices, list_sizes = ivf_common.scatter_rows(
            codes_dev, ids, slot, n_lists=n_lists, max_list=max_list)
        aux, _, _ = ivf_common.scatter_rows(aux_dev, ids, slot, n_lists=n_lists, max_list=max_list)
        return IvfPqIndex(pq_centers=torch.zeros((1, 1, 1), dtype=torch.float32, device=res.device),
                          codes=codes, list_indices=list_indices, list_sizes=list_sizes,
                          rot_sqnorms=aux[..., 0].contiguous(), pq_bits=1, packed=True,
                          rabitq=True, corrections=aux[..., 1].contiguous(), **common)
    pq_dim = rotation.shape[0] // pq_centers.shape[-1]
    codes_dev = _encode_all(ds_f32, final_labels, centers, rotation, pq_centers, pq_dim, per_cluster)
    codes, list_indices, list_sizes = ivf_common.scatter_rows(
        codes_dev, ids, slot, n_lists=n_lists, max_list=max_list)
    rot_sqnorms = _sqnorms_for(codes, centers_rot, pq_centers, per_cluster)
    nibble = kind == "nibble"
    packed = not nibble and params.pq_bits < 8 and (pq_dim * params.pq_bits) % 8 == 0
    if packed:
        codes = pack_codes_bits(codes, params.pq_bits)
    return IvfPqIndex(pq_centers=pq_centers, codes=codes, list_indices=list_indices,
                      list_sizes=list_sizes, rot_sqnorms=rot_sqnorms, pq_bits=params.pq_bits,
                      additive=nibble, packed=packed, **common)


def extend(index: IvfPqIndex, new_vectors, new_ids=None) -> IvfPqIndex:
    """Encode new vectors with the existing quantizers and repack
    (``ivf_pq::extend``). Old rows keep their lists (their codes are
    residuals against those centers); ``max_list`` never shrinks."""
    dev = index.device
    new_vectors = ser.as_tensor(new_vectors, dev)
    expects(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim, "bad extend shape")
    n_new = new_vectors.shape[0]
    if new_ids is None:
        new_ids = torch.arange(index.size, index.size + n_new, dtype=torch.int32, device=dev)
    else:
        new_ids = ser.as_tensor(new_ids, dev).to(torch.int32)
    vec_f32 = new_vectors.to(torch.float32)
    per_cluster = index.codebook_kind == PER_CLUSTER
    n_lists = index.n_lists

    flat_ids = index.list_indices.reshape(-1)
    n_old = int(index.size)
    keep_order = torch.argsort((flat_ids < 0).to(torch.int32), stable=True)[:n_old]
    if index.rabitq:
        old_codes = index.codes.reshape(-1, index.codes.shape[2])[keep_order]
        old_aux = torch.stack([index.rot_sqnorms.reshape(-1), index.corrections.reshape(-1)],
                              dim=1)[keep_order]
    else:
        old_codes = index.codes_unpacked().reshape(-1, index.pq_dim)[keep_order]
    old_ids = flat_ids[keep_order]
    old_l1 = keep_order // index.max_list

    new_cand = ivf_common.topk_labels(vec_f32, index.centers, k=8)
    all_ids = torch.cat([old_ids, new_ids])
    old_cand = old_l1[:, None].expand(n_old, new_cand.shape[1]).to(new_cand.dtype)
    cand = torch.cat([old_cand, new_cand], dim=0)
    n_total = n_old + n_new
    max_list = max(
        ivf_common.choose_max_list(cand[:, 0], n_total, n_lists, index.list_cap_factor),
        index.max_list,
    )
    slot = ivf_common.assign_slots(cand, n_lists=n_lists, max_list=max_list)
    final_labels = slot // max_list
    if index.rabitq:
        new_codes, new_aux = _rabitq_encode_all(vec_f32, final_labels[n_old:], index.centers,
                                                index.rotation, index.centers_rot, index.metric)
        codes, list_indices, list_sizes = ivf_common.scatter_rows(
            torch.cat([old_codes, new_codes]), all_ids, slot, n_lists=n_lists, max_list=max_list)
        aux, _, _ = ivf_common.scatter_rows(
            torch.cat([old_aux, new_aux]), all_ids, slot, n_lists=n_lists, max_list=max_list)
        return dataclasses.replace(index, codes=codes, list_indices=list_indices,
                                   list_sizes=list_sizes, rot_sqnorms=aux[..., 0].contiguous(),
                                   corrections=aux[..., 1].contiguous(), size=index.size + n_new)
    new_codes = _encode_all(vec_f32, final_labels[n_old:], index.centers, index.rotation,
                            index.pq_centers, index.pq_dim, per_cluster)
    codes, list_indices, list_sizes = ivf_common.scatter_rows(
        torch.cat([old_codes, new_codes]), all_ids, slot, n_lists=n_lists, max_list=max_list)
    sqn = _sqnorms_for(codes, index.centers_rot, index.pq_centers, per_cluster)
    return dataclasses.replace(
        index, codes=pack_codes_bits(codes, index.pq_bits) if index.packed else codes,
        list_indices=list_indices, list_sizes=list_sizes, rot_sqnorms=sqn,
        size=index.size + n_new,
    )


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


#: serializes the first fill of the group tables: replica pumps on their
#: own threads may serve one shared index
_FILL_LOCK = threading.Lock()


def _fused_group_tables(index: IvfPqIndex, group: int):
    """B2's group tables (:func:`raft_tpu_torch.ops.pq_scan.group_tables`)
    of the index without a filter, for units of ``group`` lists: built at
    the first fused search and kept on the index (a plain attribute, so a
    rebuilt or extended index starts without them)."""
    with _FILL_LOCK:
        cache = index.__dict__.setdefault("_fused_group_tables", {})
        if group not in cache:
            n_lists, m = index.list_indices.shape
            cache[group] = group_tables((index.list_indices >= 0).reshape(n_lists // group, 1,
                                                                           group * m))
        return cache[group]


def _probe_search(index: IvfPqIndex, codes_u, queries, filter_bits, *, k: int, n_probes: int,
                  lut_dtype: Optional[torch.dtype]):
    """Per-probe f32 LUT gather + running merge (``ivf_pq.py:1183-1278``),
    several probes a merge (:func:`ivf_common.merge_probes`)."""
    metric = index.metric
    nq = queries.shape[0]
    qf = queries.to(torch.float32)
    q_dot_c = qf @ index.centers.T
    coarse = ivf_common.coarse_scores(index.centers, qf, metric)
    _, probes = select_k(coarse, n_probes, select_min=True)
    probes = probes.to(torch.int64)
    pq_dim = codes_u.shape[2]
    q_sub = (qf @ index.rotation.T).reshape(nq, pq_dim, -1)
    per_cluster = index.codebook_kind == PER_CLUSTER
    pqc_all = index.pq_centers
    pqc_norm = torch.sum(pqc_all * pqc_all, dim=-1)
    select_min = metric != DistanceType.InnerProduct
    worst = worst_value(torch.float32, select_min)

    def tiles():
        for p in range(n_probes):
            list_id = probes[:, p]
            ids_p = index.list_indices[list_id]
            if metric == DistanceType.InnerProduct:
                if per_cluster:
                    lut = torch.einsum("npl,nkl->npk", q_sub, pqc_all[list_id])
                else:
                    lut = torch.einsum("npl,pkl->npk", q_sub, pqc_all)
            else:
                diff = q_sub - index.centers_rot[list_id].reshape(nq, pq_dim, -1)
                dn = torch.sum(diff * diff, dim=-1)
                if per_cluster:
                    dots = torch.einsum("npl,nkl->npk", diff, pqc_all[list_id])
                    cn = pqc_norm[list_id][:, None, :]
                else:
                    dots = torch.einsum("npl,pkl->npk", diff, pqc_all)
                    cn = pqc_norm[None, :, :]
                lut = dn[:, :, None] - 2.0 * dots + cn
            if lut_dtype is not None and lut_dtype != torch.float32:
                lut = lut.to(lut_dtype).to(torch.float32)
            codes_t = codes_u[list_id].permute(0, 2, 1).to(torch.int64)  # [nq, pq_dim, max_list]
            dist = torch.sum(torch.gather(lut, 2, codes_t), dim=1)
            if metric == DistanceType.InnerProduct:
                dist = dist + torch.gather(q_dot_c, 1, list_id[:, None])
            valid = ivf_common.valid_slots(ids_p, filter_bits)
            dist = torch.where(valid, dist, torch.full_like(dist, worst))
            ids_masked = torch.where(valid, ids_p, torch.full_like(ids_p, -1))
            yield dist, ids_masked

    acc_v, acc_i = ivf_common.merge_probes(tiles(), nq=nq, k=k, n_probes=n_probes,
                                           cols=index.list_indices.shape[1],
                                           select_min=select_min, device=qf.device)
    if metric == DistanceType.L2SqrtExpanded:
        acc_v = torch.where(acc_i >= 0, torch.sqrt(torch.clamp(acc_v, min=0.0)), acc_v)
    return acc_v, acc_i


def _rabitq_probe_search(index: IvfPqIndex, queries, filter_bits, *, k: int, n_probes: int):
    """Probe-at-a-time RaBitQ estimator (``ivf_pq.py:1439-1515``)."""
    metric = index.metric
    nq = queries.shape[0]
    qf = queries.to(torch.float32)
    bpr = index.codes.shape[2]
    q_dot_c = qf @ index.centers.T
    coarse = ivf_common.coarse_scores(index.centers, qf, metric)
    _, probes = select_k(coarse, n_probes, select_min=True)
    probes = probes.to(torch.int64)
    q_rot = qf @ index.rotation.T
    sq = torch.sum(q_rot, dim=1)
    qn = torch.sum(q_rot * q_rot, dim=1)
    coef = 1.0 if metric == DistanceType.InnerProduct else 2.0
    select_min = metric != DistanceType.InnerProduct
    worst = worst_value(torch.float32, select_min)

    def tiles():
        for p in range(n_probes):
            list_id = probes[:, p]
            ids_p = index.list_indices[list_id]
            bits = sign_bits(index.codes[list_id].reshape(-1, bpr)).to(torch.float32)
            bq = torch.bmm(bits.reshape(nq, -1, 8 * bpr), q_rot[:, :, None])[:, :, 0]
            qdc = torch.gather(q_dot_c, 1, list_id[:, None])
            mscore = (coef * qdc + index.corrections[list_id] * (bq - 0.5 * sq[:, None])
                      - index.rot_sqnorms[list_id])
            if metric == DistanceType.InnerProduct:
                dist = mscore
            else:
                dist = torch.clamp(qn[:, None] - mscore, min=0.0)
            valid = ivf_common.valid_slots(ids_p, filter_bits)
            dist = torch.where(valid, dist, torch.full_like(dist, worst))
            ids_masked = torch.where(valid, ids_p, torch.full_like(ids_p, -1))
            yield dist, ids_masked

    acc_v, acc_i = ivf_common.merge_probes(tiles(), nq=nq, k=k, n_probes=n_probes,
                                           cols=index.list_indices.shape[1],
                                           select_min=select_min, device=qf.device)
    if metric == DistanceType.L2SqrtExpanded:
        acc_v = torch.where(acc_i >= 0, torch.sqrt(torch.clamp(acc_v, min=0.0)), acc_v)
    return acc_v, acc_i


def scan_chunk_lists(n_lists: int, max_list: int) -> int:
    """Lists per chunk of the decode scan: about 256k rows (the decoded
    chunk is ``[rows, rot_dim]``), rounded down to a divisor of
    ``n_lists``."""
    g = max(1, 262144 // max(max_list, 1))
    while n_lists % g:
        g -= 1
    return g


def scan_bf16(lut_dtype, device) -> bool:
    """Whether the decode scan scores in bf16: a bf16 ``lut_dtype`` on the
    card (the JAX package's TPU-only mode; on the CPU both packages score in
    f32)."""
    return lut_dtype == torch.bfloat16 and torch.device(device).type == "cuda"


def pq_scan_core(pq_centers, codes, list_indices, rot_sqnorms, q_rot, q_dot_c, probed,
                 filter_bits, *, k: int, metric: DistanceType, per_cluster: bool,
                 has_filter: bool, chunk_lists: int,
                 bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-and-score over (a shard of) the code lists
    (``ivf_pq.py:1045-1180``). ``codes`` are unpacked ``[n_lists, max_list,
    pq_dim]``; ``list_indices``, ``rot_sqnorms``, ``q_dot_c [nq, n_lists]``
    and ``probed`` may all be a shard's slice (ids are global). Each chunk is
    decoded by a codebook gather (the values of the JAX package's one-hot
    matmul) and scored by one matmul: L2 ``2 q_rot.r + 2 q.c - sqn``, IP
    ``q_rot.r + q.c``; empty, filtered or unprobed slots get ``-inf``; a
    ``max(2k, 16)`` shortlist per chunk is merged into the running top-k,
    exactly (``lax.top_k``'s tie order). ``filter_bits`` is read only when
    ``has_filter``, as in the JAX package. Returns ``(distances, ids)``."""
    nq = q_rot.shape[0]
    if not has_filter:
        filter_bits = None
    n_lists, max_list, pq_dim = codes.shape
    rot_dim = q_rot.shape[1]
    G, M = chunk_lists, max_list
    expects(n_lists % G == 0, "chunk_lists %d does not divide %d lists", G, n_lists)
    dev = q_rot.device
    cdtype = torch.bfloat16 if bf16 else torch.float32
    qc = q_rot.to(cdtype)
    books = pq_centers.to(cdtype)
    jidx = torch.arange(pq_dim, device=dev)[None, None, :]
    acc_v = torch.full((nq, k), float("-inf"), dtype=torch.float32, device=dev)
    acc_i = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    for c in range(n_lists // G):
        lo, hi = c * G, (c + 1) * G
        cod = codes[lo:hi].to(torch.int64)  # [G, M, pq_dim]
        if per_cluster:
            resid = books[lo:hi][torch.arange(G, device=dev)[:, None, None], cod]
        else:
            resid = books[jidx, cod]
        resid = resid.reshape(G * M, rot_dim)
        score = (qc @ resid.T).to(torch.float32)
        del resid
        pad_pen = torch.where(ivf_common.valid_slots(list_indices[lo:hi].reshape(G * M),
                                                     filter_bits), 0.0, neg_inf)
        qdc = q_dot_c[:, lo:hi]
        if metric == DistanceType.InnerProduct:
            score.view(nq, G, M).add_(torch.where(probed[:, lo:hi], qdc, neg_inf)[:, :, None])
            score.add_(pad_pen[None, :])
        else:
            sqn = rot_sqnorms[lo:hi].reshape(G * M)
            score.mul_(2.0).sub_((sqn - pad_pen)[None, :])
            score.view(nq, G, M).add_(torch.where(probed[:, lo:hi], 2.0 * qdc, neg_inf)[:, :, None])
        kk = min(max(2 * k, 16), G * M)
        v, i = select_k(score, kk, select_min=False)
        del score
        nv, ni = select_k(torch.cat([acc_v, v], dim=1), k, select_min=False)
        acc_i = torch.gather(torch.cat([acc_i, i + c * G * M], dim=1), 1, ni.to(torch.int64))
        acc_v = nv
    idx = list_indices.reshape(-1)[acc_i.to(torch.int64).reshape(-1)].reshape(nq, k)
    idx = torch.where(torch.isfinite(acc_v), idx, -1).to(torch.int32)
    if metric == DistanceType.InnerProduct:
        return acc_v, idx
    qn = torch.sum(q_rot * q_rot, dim=1)
    out = torch.clamp(qn[:, None] - acc_v, min=0.0)
    if metric == DistanceType.L2SqrtExpanded:
        out = torch.sqrt(out)
    return torch.where(idx >= 0, out, float("inf")), idx


def _ivf_pq_scan_impl(centers, rotation, pq_centers, codes, list_indices, rot_sqnorms, queries,
                      filter_bits, *, k: int, n_probes: int, metric: DistanceType,
                      per_cluster: bool, chunk_lists: int, bf16: bool):
    """The dense decode scan of one query batch (``ivf_pq.py:985-1040``):
    the coarse product (both the probe selector and the ``q.c`` term),
    the probe mask, the rotated queries, then :func:`pq_scan_core`."""
    nq = queries.shape[0]
    qf = queries.to(torch.float32)
    with obs.span("ivf_pq.search.coarse_probe", nq=nq, n_probes=n_probes) as sp:
        q_dot_c = qf @ centers.T
        probed = sp.sync(ivf_common.probed_from_coarse(
            ivf_common.coarse_from_dots(q_dot_c, centers, metric), n_probes))
    q_rot = qf @ rotation.T
    with obs.span("ivf_pq.search.pq_scan", nq=nq, k=k) as sp:
        return sp.sync(pq_scan_core(pq_centers, codes, list_indices, rot_sqnorms, q_rot, q_dot_c,
                                    probed, filter_bits, k=k, metric=metric,
                                    per_cluster=per_cluster, has_filter=filter_bits is not None,
                                    chunk_lists=chunk_lists, bf16=bf16))


#: scratch of one chunk of the RaBitQ scan on the card: its sign bits as
#: f32, the bit product and the scores
RABITQ_SCAN_CHUNK_BYTES = 256 << 20


def rabitq_scan_chunk_lists(n_lists: int, max_list: int, rot_dim: int, nq: int) -> int:
    """Lists per chunk of the RaBitQ scan: at most :func:`scan_chunk_lists`'s
    and as many as keep the chunk's scratch (``[rows, rot_dim]`` f32 bits,
    ``[nq, rows]`` f32 products and scores) under
    :data:`RABITQ_SCAN_CHUNK_BYTES`, rounded down to a divisor of
    ``n_lists``. The chunking does not change the result: each chunk's
    shortlist holds its exact top-k, merged in slot order."""
    rows = RABITQ_SCAN_CHUNK_BYTES // (4 * rot_dim + 8 * max(nq, 1))
    g = max(1, min(scan_chunk_lists(n_lists, max_list), rows // max(max_list, 1)))
    while n_lists % g:
        g -= 1
    return g


def rabitq_scan_core(codes, corrections, list_indices, rot_sqnorms, q_rot, q_dot_c, probed,
                     filter_bits, *, k: int, metric: DistanceType, has_filter: bool,
                     chunk_lists: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RaBitQ dense scan over (a shard of) the lists
    (``ivf_pq.py:1338-1434``): per chunk of ``chunk_lists`` lists the sign
    bits as f32 and one ``[nq, rot_dim] x [rot_dim, rows]`` FP32 product,
    then the estimator as a score to maximize::

        score = g (b.q_rot - sum(q_rot) / 2) - C1 + coef (q.c)

    (coef 2 for L2, 1 for IP); empty, filtered and unprobed slots get
    ``-inf``. A ``max(2k, 16)`` shortlist a chunk is merged into the running
    top-k exactly (``lax.top_k``'s tie order, as :func:`pq_scan_core`).
    L2 returns ``max(||q||^2 - score, 0)`` (its root for L2Sqrt), IP the
    score. ``filter_bits`` is read only when ``has_filter``, as in the JAX
    package. Returns ``(distances, ids)``."""
    nq, D = q_rot.shape
    if not has_filter:
        filter_bits = None
    n_lists, max_list, _ = codes.shape
    G, M = chunk_lists, max_list
    expects(n_lists % G == 0, "chunk_lists %d does not divide %d lists", G, n_lists)
    dev = q_rot.device
    sq = torch.sum(q_rot, dim=1)
    coef = 1.0 if metric == DistanceType.InnerProduct else 2.0
    acc_v = torch.full((nq, k), float("-inf"), dtype=torch.float32, device=dev)
    acc_i = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    for c in range(n_lists // G):
        lo, hi = c * G, (c + 1) * G
        bits = sign_bits(codes[lo:hi].reshape(G * M, -1)).to(torch.float32)  # [G*M, D]
        bq = q_rot @ bits.T
        del bits
        gg = corrections[lo:hi].reshape(G * M)
        c1 = rot_sqnorms[lo:hi].reshape(G * M)
        score = gg[None, :] * (bq - 0.5 * sq[:, None]) - c1[None, :]
        del bq
        pad_pen = torch.where(ivf_common.valid_slots(list_indices[lo:hi].reshape(G * M),
                                                     filter_bits), 0.0, neg_inf)
        probe_pen = torch.where(probed[:, lo:hi], coef * q_dot_c[:, lo:hi], neg_inf)
        score.view(nq, G, M).add_(probe_pen[:, :, None])
        score.add_(pad_pen[None, :])
        kk = min(max(2 * k, 16), G * M)
        v, i = select_k(score, kk, select_min=False)
        del score
        nv, ni = select_k(torch.cat([acc_v, v], dim=1), k, select_min=False)
        acc_i = torch.gather(torch.cat([acc_i, i + c * G * M], dim=1), 1, ni.to(torch.int64))
        acc_v = nv
    idx = list_indices.reshape(-1)[acc_i.to(torch.int64).reshape(-1)].reshape(nq, k)
    idx = torch.where(torch.isfinite(acc_v), idx, -1).to(torch.int32)
    if metric == DistanceType.InnerProduct:
        return acc_v, idx
    qn = torch.sum(q_rot * q_rot, dim=1)
    out = torch.clamp(qn[:, None] - acc_v, min=0.0)
    if metric == DistanceType.L2SqrtExpanded:
        out = torch.sqrt(out)
    return torch.where(idx >= 0, out, float("inf")), idx


def _ivf_rabitq_scan_impl(centers, rotation, codes, corrections, list_indices, rot_sqnorms,
                          queries, filter_bits, *, k: int, n_probes: int, metric: DistanceType):
    """The RaBitQ dense scan of one query batch (``ivf_pq.py:1280-1335``):
    the coarse product and probe mask, the rotated queries, then
    :func:`rabitq_scan_core` under the ``ivf_pq.search.rabitq_xla`` span."""
    nq = queries.shape[0]
    qf = queries.to(torch.float32)
    with obs.span("ivf_pq.search.coarse_probe", nq=nq, n_probes=n_probes) as sp:
        q_dot_c = qf @ centers.T
        probed = sp.sync(ivf_common.probed_from_coarse(
            ivf_common.coarse_from_dots(q_dot_c, centers, metric), n_probes))
    q_rot = qf @ rotation.T
    g = rabitq_scan_chunk_lists(codes.shape[0], codes.shape[1], q_rot.shape[1], nq)
    with obs.span("ivf_pq.search.rabitq_xla", nq=nq, k=k) as sp:
        return sp.sync(rabitq_scan_core(codes, corrections, list_indices, rot_sqnorms, q_rot,
                                        q_dot_c, probed, filter_bits, k=k, metric=metric,
                                        has_filter=filter_bits is not None, chunk_lists=g))


def fused_rank_group(index: IvfPqIndex, params: IvfPqSearchParams) -> Tuple[torch.Tensor, int]:
    """``(center_rank, lists per unit)`` of the fused scan: the index's rank
    and ``fused_group``, or for an index without a rank (saved before v3)
    a computed PCA-bisection rank and single-list units; the group is
    rounded down to a divisor of ``n_lists``."""
    rank, group = index.center_rank, params.fused_group
    if rank is None:
        rank = torch.from_numpy(spatial_center_rank(index.centers.cpu().numpy())).to(index.device)
        group = 1
    group = max(1, min(group, index.n_lists))
    while index.n_lists % group:
        group -= 1
    return rank, group


def search(
    index: IvfPqIndex,
    queries,
    k: int,
    params: Optional[IvfPqSearchParams] = None,
    prefilter: Optional[Bitset] = None,
    query_batch: int = 1024,
    mode: str = "auto",
    res: Optional[Resources] = None,
    dataset=None,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC search over probed lists (``ivf_pq::search``). Returns best-first
    ``(distances [nq, k] f32, indices [nq, k] i32)`` on the index's device;
    unfilled slots get id -1. Distances are PQ (or RaBitQ) estimates; with
    ``dataset`` and ``params.refine_ratio > 1`` (default 8) the scan keeps
    ``k * refine_ratio`` candidates and re-ranks them exactly. ``mode``:
    ``"fused"``, ``"scan"``, ``"probe"`` or ``"auto"`` (from 128 queries,
    fused on a CUDA index when eligible, scan elsewhere); queries are searched in batches of ``query_batch`` with a
    zero-padded tail. A CUDA index runs the kernels and never falls back:
    a kernel that fails raises, as does an error injected at the
    ``pallas.pq_scan`` fault seam, in ``auto`` and explicit mode alike.

    With :mod:`raft_tpu_torch.obs` enabled the call records a synced
    ``ivf_pq.search`` span with per-phase children (``coarse_probe`` /
    ``pq_scan`` / ``probe_scan`` / ``fused`` / ``rabitq_scan`` /
    ``refine``) and the JAX package's counters (``ivf_pq.search.calls{mode,
    lut}``, ``.queries``, ``.rabitq.queries``, ``.n_probes``,
    ``.refine_candidates_per_query``); disabled, one flag check."""
    if not obs.is_enabled():
        return _search_dispatch(index, queries, k, params, prefilter, query_batch, mode, res,
                                dataset, **kwargs)
    with obs.span("ivf_pq.search", k=k, nq=len(queries)) as sp:
        return sp.sync(_search_dispatch(index, queries, k, params, prefilter, query_batch, mode,
                                        res, dataset, **kwargs))


def _lut_name(lut_dtype) -> str:
    """The ``lut`` label of ``ivf_pq.search.calls`` (the dtype's name)."""
    return "default" if lut_dtype is None else str(lut_dtype).rsplit(".", 1)[-1]


def _search_dispatch(index: IvfPqIndex, queries, k: int, params: Optional[IvfPqSearchParams],
                     prefilter: Optional[Bitset], query_batch: int, mode: str,
                     res: Optional[Resources], dataset, **kwargs):
    """Mode routing and query batching behind :func:`search` (apart, so the
    obs-off path costs one flag check)."""
    if params is None:
        params = IvfPqSearchParams(**kwargs)
    dev = index.device
    queries = ser.as_tensor(queries, dev)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim, "bad query shape")
    expects(k >= 1, "k must be >= 1")
    if dataset is not None and params.refine_ratio > 1:
        from raft_tpu_torch.neighbors.refine import check_refine_dataset, refine, refine_source

        check_refine_dataset(dataset, index.size, "ivf_pq")
        inner = dataclasses.replace(params, refine_ratio=1)
        kk = min(k * params.refine_ratio, index.size)
        _, cand = search(index, queries, kk, inner, prefilter=prefilter,
                         query_batch=query_batch, mode=mode, res=res)
        if obs.is_enabled():
            obs.observe("ivf_pq.search.refine_candidates_per_query", float(kk))
        with obs.span("ivf_pq.search.refine", k=k, candidates=int(kk)) as sp:
            return sp.sync(refine(refine_source(dataset, dev), queries, cand, k,
                                  metric=index.metric))
    if prefilter is not None:
        expects(prefilter.size >= index.size, "prefilter smaller than index")
    filter_bits = prefilter.bits.to(dev) if prefilter is not None else None
    n_probes = min(params.n_probes, index.n_lists)
    nq = queries.shape[0]
    if index.rabitq:
        return _rabitq_modes(index, queries, k, params, filter_bits, n_probes, query_batch, mode)

    fused_ok = (index.codebook_kind == PER_SUBSPACE and (index.additive or index.ksub <= 256)
                and index.metric in _SUPPORTED)
    wants_f32_lut = params.lut_dtype == torch.float32
    if mode == "auto":
        mode = ivf_common.auto_search_mode(dev, nq, fused_ok and not wants_f32_lut,
                                           algo="ivf_pq")
    expects(mode in ("scan", "probe", "fused"), "mode must be auto|scan|probe|fused, got %r",
            mode)
    if obs.is_enabled():
        obs.inc("ivf_pq.search.calls", mode=mode, lut=_lut_name(params.lut_dtype))
        obs.inc("ivf_pq.search.queries", float(nq))
        obs.observe("ivf_pq.search.n_probes", float(n_probes))
    if mode == "scan":
        expects(index.metric in _SUPPORTED, "scan mode: unsupported metric")
        g = scan_chunk_lists(index.n_lists, index.max_list)
        codes_u = index.codes_unpacked()
        bf16 = scan_bf16(params.lut_dtype, dev)

        def run_scan(qc):
            return _ivf_pq_scan_impl(
                index.centers, index.rotation, index.pq_centers, codes_u, index.list_indices,
                index.rot_sqnorms, qc, filter_bits, k=k, n_probes=n_probes, metric=index.metric,
                per_cluster=index.codebook_kind == PER_CLUSTER, chunk_lists=g, bf16=bf16)

        return _batched(run_scan, queries, query_batch)
    if mode == "fused":
        if wants_f32_lut:
            warnings.warn(
                "mode='fused' computes the LUT in bf16 by construction; the explicit "
                "lut_dtype=float32 request is ignored (use mode='probe' or 'auto' to honor it)",
                UserWarning, stacklevel=2,
            )
        expects(fused_ok, "fused mode needs per_subspace codebooks (ksub <= 256 or nibble) and "
                "a supported metric")
        code_mode, ksub = fused_code_layout(index)
        books = nibble_books(index.pq_centers) if index.additive else index.pq_centers
        rank, group = fused_rank_group(index, params)
        tables = _fused_group_tables(index, group) if filter_bits is None else None

        def run(qc):
            return ivf_pq_fused_search(
                index.centers, index.centers_rot, rank, index.rotation, books, index.codes,
                index.list_indices, index.rot_sqnorms, qc, filter_bits, k=k, n_probes=n_probes,
                metric=index.metric, qt=params.fused_qt, probe_factor=params.fused_probe_factor,
                group=group, merge=params.fused_merge, code_mode=code_mode, ksub=ksub,
                extract_every=params.fused_extract_every, decode_cols=params.fused_decode_cols,
                tables=tables,
            )

        # host-level seam before B2: an injected error propagates (no fallback)
        faults.fire("pallas.pq_scan", nq=int(nq))
        with obs.span("ivf_pq.search.fused", nq=nq, k=k, n_probes=n_probes) as sp:
            return sp.sync(_batched(run, queries, query_batch))

    # the per-probe LUT gather holds [batch, pq_dim, max_list] lanes: cap
    # the batch so that stays under ~512 MB
    per_q = max(1, index.pq_dim * index.max_list * 4)
    query_batch = max(1, min(query_batch, (512 << 20) // per_q))
    codes_u = index.codes_unpacked()

    def run_probe(qc):
        with obs.span("ivf_pq.search.probe_scan", nq=qc.shape[0], k=k) as sp:
            return sp.sync(_probe_search(index, codes_u, qc, filter_bits, k=k, n_probes=n_probes,
                                         lut_dtype=params.lut_dtype))

    return _batched(run_probe, queries, query_batch)


def _rabitq_modes(index: IvfPqIndex, queries, k: int, params: IvfPqSearchParams, filter_bits,
                  n_probes: int, query_batch: int, mode: str):
    """Mode routing for RaBitQ indexes: the same fused / scan / probe trio,
    backed by kernel B3, the dense sign-bit scan (:func:`rabitq_scan_core`)
    and the probe-at-a-time estimator."""
    fused_ok = index.metric in _SUPPORTED
    if mode == "auto":
        mode = ivf_common.auto_search_mode(index.device, queries.shape[0], fused_ok,
                                           algo="ivf_pq")
    expects(mode in ("scan", "probe", "fused"), "mode must be auto|scan|probe|fused, got %r",
            mode)
    nq = queries.shape[0]
    if obs.is_enabled():
        obs.inc("ivf_pq.search.calls", mode=mode, lut="rabitq")
        obs.inc("ivf_pq.search.queries", float(nq))
        obs.inc("ivf_pq.search.rabitq.queries", float(nq))
        obs.observe("ivf_pq.search.n_probes", float(n_probes))
    if mode == "fused":
        expects(fused_ok, "fused rabitq mode needs a supported metric")
        rank, group = fused_rank_group(index, params)

        def run(qc):
            return ivf_rabitq_fused_search(
                index.centers, index.centers_rot, rank, index.rotation, index.codes,
                index.list_indices, index.rot_sqnorms, index.corrections, qc, filter_bits, k=k,
                n_probes=n_probes, metric=index.metric, qt=params.fused_qt,
                probe_factor=params.fused_probe_factor, group=group, merge=params.fused_merge,
                extract_every=params.fused_extract_every,
            )

        # the PQ fused path's seam covers B3 too, as in the JAX package
        faults.fire("pallas.pq_scan", nq=int(nq))
        with obs.span("ivf_pq.search.rabitq_scan", nq=nq, k=k, n_probes=n_probes) as sp:
            return sp.sync(_batched(run, queries, query_batch))
    if mode == "scan":

        def run_scan(qc):
            return _ivf_rabitq_scan_impl(
                index.centers, index.rotation, index.codes, index.corrections,
                index.list_indices, index.rot_sqnorms, qc, filter_bits, k=k, n_probes=n_probes,
                metric=index.metric)

        return _batched(run_scan, queries, query_batch)
    # the unpacked bits are [batch, max_list, D] f32: cap as the PQ probe path
    per_q = max(1, index.rot_dim * index.max_list * 4)
    query_batch = max(1, min(query_batch, (512 << 20) // per_q))

    def run_probe(qc):
        with obs.span("ivf_pq.search.probe_scan", nq=qc.shape[0], k=k) as sp:
            return sp.sync(_rabitq_probe_search(index, qc, filter_bits, k=k, n_probes=n_probes))

    return _batched(run_probe, queries, query_batch)


# -- carrying an index across packages -------------------------------------


def from_numpy(arrays: dict, metric, size: int, *, codebook_kind: str = PER_SUBSPACE,
               pq_bits: int = 8, list_cap_factor: float = 0.0, additive: bool = False,
               packed: bool = False, rabitq: bool = False, device=None) -> IvfPqIndex:
    """An index from numpy arrays (e.g. a JAX index's fields through
    ``np.asarray``): keys ``centers``, ``centers_rot``, ``rotation``,
    ``pq_centers``, ``codes``, ``list_indices``, ``list_sizes``,
    ``rot_sqnorms`` and optionally ``center_rank``, ``corrections``.
    ``device=None`` means ``cuda``."""
    dev = ensure_resources(device=device if device is not None else "cuda").device

    def get(name):
        a = arrays.get(name)
        return None if a is None else ser.from_numpy(np.asarray(a), dev)

    return IvfPqIndex(
        centers=get("centers").to(torch.float32),
        centers_rot=get("centers_rot").to(torch.float32),
        rotation=get("rotation").to(torch.float32),
        pq_centers=get("pq_centers").to(torch.float32),
        codes=get("codes").to(torch.uint8),
        list_indices=get("list_indices").to(torch.int32),
        list_sizes=get("list_sizes").to(torch.int32),
        rot_sqnorms=get("rot_sqnorms").to(torch.float32),
        metric=resolve_metric(metric),
        codebook_kind=codebook_kind,
        pq_bits=int(pq_bits),
        size=int(size),
        list_cap_factor=float(list_cap_factor),
        additive=bool(additive),
        packed=bool(packed),
        center_rank=get("center_rank"),
        rabitq=bool(rabitq),
        corrections=get("corrections"),
    )


# -- serialization (same bytes as the JAX package) --------------------------

_KIND = "ivf_pq"
_VERSION = 4  # v4 adds the rabitq flag + corrections array


def _write_body(index: IvfPqIndex, stream: BinaryIO) -> None:
    ser.serialize_scalar(stream, int(index.metric), "int32")
    ser.serialize_scalar(stream, int(index.size), "int64")
    ser.serialize_scalar(stream, int(index.pq_bits), "int32")
    ser.serialize_scalar(stream, int(index.codebook_kind == PER_CLUSTER), "int32")
    ser.serialize_scalar(stream, float(index.list_cap_factor), "float64")
    ser.serialize_scalar(stream, int(index.additive), "int32")
    ser.serialize_scalar(stream, int(index.packed), "int32")
    ser.serialize_scalar(stream, int(index.center_rank is not None), "int32")
    ser.serialize_scalar(stream, int(index.rabitq), "int32")
    for arr in (index.centers, index.centers_rot, index.rotation, index.pq_centers, index.codes,
                index.list_indices, index.list_sizes, index.rot_sqnorms):
        ser.serialize_array(stream, arr)
    if index.rabitq:
        ser.serialize_array(stream, index.corrections)
    if index.center_rank is not None:
        ser.serialize_array(stream, index.center_rank)


def save(index: IvfPqIndex, stream: BinaryIO) -> None:
    body = io.BytesIO()
    _write_body(index, body)
    ser.save_stream(stream, _KIND, _VERSION, body.getvalue())


def load(stream: BinaryIO, res: Optional[Resources] = None, device=None) -> IvfPqIndex:
    """Load an index saved by either package onto ``res``/``device``
    (default ``cuda``)."""
    dev = ensure_resources(res, device).device
    version, stream = ser.load_stream(stream, _KIND)
    metric = DistanceType(ser.deserialize_scalar(stream, "int32"))
    size = int(ser.deserialize_scalar(stream, "int64"))
    pq_bits = int(ser.deserialize_scalar(stream, "int32"))
    per_cluster = bool(ser.deserialize_scalar(stream, "int32"))
    cap_factor = float(ser.deserialize_scalar(stream, "float64")) if version >= 2 else 0.0
    additive = packed = has_rank = rabitq = False
    if version >= 3:
        additive = bool(ser.deserialize_scalar(stream, "int32"))
        packed = bool(ser.deserialize_scalar(stream, "int32"))
        has_rank = bool(ser.deserialize_scalar(stream, "int32"))
    if version >= 4:
        rabitq = bool(ser.deserialize_scalar(stream, "int32"))
    centers, centers_rot, rotation, pq_centers, codes, list_indices, list_sizes = (
        ser.deserialize_array(stream, dev) for _ in range(7))
    if version >= 2:
        rot_sqnorms = ser.deserialize_array(stream, dev)
    else:
        rot_sqnorms = _sqnorms_for(codes, centers_rot, pq_centers, per_cluster)
    corrections = ser.deserialize_array(stream, dev) if rabitq else None
    center_rank = ser.deserialize_array(stream, dev) if has_rank else None
    return IvfPqIndex(
        centers=centers, centers_rot=centers_rot, rotation=rotation, pq_centers=pq_centers,
        codes=codes, list_indices=list_indices, list_sizes=list_sizes, rot_sqnorms=rot_sqnorms,
        metric=metric, codebook_kind=PER_CLUSTER if per_cluster else PER_SUBSPACE,
        pq_bits=pq_bits, size=size, list_cap_factor=cap_factor, additive=additive,
        packed=packed, center_rank=center_rank, rabitq=rabitq, corrections=corrections,
    )


def save_path(index: IvfPqIndex, path: str) -> str:
    """Atomic (temp-then-rename) checksummed snapshot at ``path``."""
    return ser.atomic_write(path, lambda f: save(index, f))


def load_path(path: str, res: Optional[Resources] = None, device=None) -> IvfPqIndex:
    with open(path, "rb") as f:
        return load(f, res=res, device=device)
