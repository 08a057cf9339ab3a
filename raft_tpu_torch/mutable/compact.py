"""Compaction: fold delta rows + tombstones into a rebuilt main segment
(``raft_tpu.mutable.compact`` counterpart).

Compaction takes every *live* row (main rows not tombstoned, plus delta
rows not tombstoned, in stable segment order), rebuilds the main-segment
index from scratch, and publishes the result as generation ``g+1``:

1. write ``gen-NNNNNNNN/rows.bin`` (raw rows + global ids, checksummed
   v4 envelope) and ``gen-NNNNNNNN/main.idx`` (the per-algo snapshot),
   both via the atomic temp-fsync-rename writer;
2. flip ``MANIFEST.json`` to the new generation with
   :func:`raft_tpu_torch.mutable.manifest.swap` — the only mutable file;
3. switch the in-memory index over (empty delta, empty tombstones, a
   fresh per-generation WAL), then — after the index lock is released,
   so nobody queues behind filesystem work — best-effort delete the
   old generation's artifacts.

Crash matrix: a kill at the ``compact.merge`` seam (before any byte is
written) or anywhere during step 1 leaves the old manifest pointing at
the old, untouched generation — recovery sees the pre-compaction state
with its WAL intact. A kill at the ``manifest.swap`` seam leaves the new
generation's files on disk as orphans but the old manifest live — still
pre-state. Only once the rename lands is the new generation visible,
and then it is complete by construction.

The rebuild is deterministic (same rows in the same order through the
same seeded builder), so post-compaction search is bit-for-bit equal to
a from-scratch build over the live rows. Compaction builds a new index
object every time and never changes a main index's rows in place, so the
per-index caches (IVF-PQ's group tables, CAGRA's seed rows) stay valid.

This module is the **foreground** mode: the whole fold runs under the
index lock, so writers and fresh snapshots queue behind the rebuild
(already-taken snapshots keep serving). A serving system wants
:mod:`raft_tpu_torch.mutable.maintenance`, which pins a snapshot,
rebuilds off-lock on a worker thread, and re-enters the lock only for the
catch-up replay + pointer flip. Both modes share the artifact writers
and the memory switch below, and both retry transient failures through
:mod:`raft_tpu_torch.robust.retry` (the ``mutable.compact.retries``
counter); the final failure re-raises the *underlying* error, so a
chaos kill surfaces as itself, not as a ``RetryError``.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.mutable import manifest as man
from raft_tpu_torch.mutable import segments as seg
from raft_tpu_torch.mutable.wal import segment_paths
from raft_tpu_torch.robust import faults
from raft_tpu_torch.robust.retry import RetryError, RetryPolicy, retry_call

#: default backoff for compaction attempts: quick, bounded retries —
#: a compaction that keeps failing is reported, not looped forever
COMPACT_RETRY_POLICY = RetryPolicy(
    max_attempts=3, base_delay_s=0.01, multiplier=2.0, max_delay_s=0.25
)


def _save_main(algo: str, index, path: str) -> str:
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

    if algo == "brute_force":
        return brute_force.save_path(index, path)
    if algo == "ivf_flat":
        return ivf_flat.save_path(index, path)
    if algo == "ivf_pq":
        return ivf_pq.save_path(index, path)
    if algo == "cagra":
        # rows live in the sidecar; don't store the dataset twice
        return cagra.save_path(index, path, include_dataset=False)
    raise ValueError(f"unknown mutable algo {algo!r}")


def _write_generation(
    mut: "seg.MutableIndex", new_gen: int, ids: np.ndarray, vecs: np.ndarray, index
) -> Tuple[str, Optional[str]]:
    """Write generation ``new_gen``'s immutable artifacts (rows sidecar
    + per-algo main snapshot) through the atomic writers and return
    their manifest-relative paths. Touches nothing the live manifest
    references, so it is safe to run without the index lock."""
    gen_name = seg._gen_dirname(new_gen)
    gen_dir = os.path.join(mut.directory, gen_name)
    os.makedirs(gen_dir, exist_ok=True)
    rows_rel = os.path.join(gen_name, "rows.bin")
    seg._save_rows(os.path.join(mut.directory, rows_rel), ids, vecs)
    main_rel = None
    if index is not None:
        main_rel = os.path.join(gen_name, "main.idx")
        _save_main(mut.algo, index, os.path.join(mut.directory, main_rel))
    return rows_rel, main_rel


def _clear_stale_wal(path: str) -> None:
    """Unlink leftover WAL segments at a new generation's log path.
    Generation numbers are reused when a failed compaction retries, so
    a crashed earlier attempt may have left catch-up records here;
    replaying them on top of a freshly published generation would
    double-apply mutations. Must run *before* the manifest flip makes
    the path live."""
    for sp in segment_paths(path):
        try:
            os.unlink(sp)
        except OSError:  # the path relinks below; open() would re-truncate
            pass


def _publish(mut: "seg.MutableIndex", new_gen: int, rows_rel, main_rel) -> None:
    """The atomic flip: swap ``MANIFEST.json`` to generation
    ``new_gen``. Before the rename recovery sees the old generation,
    after it the new — never a mixture."""
    man.swap(
        mut.directory,
        man.Manifest(
            generation=new_gen,
            algo=mut.algo,
            dim=mut.dim,
            main=main_rel,
            rows=rows_rel,
            wal=seg._wal_name(new_gen),
            next_id=mut.next_id,
        ),
    )


def _switch_memory(
    mut: "seg.MutableIndex",
    new_gen: int,
    ids: np.ndarray,
    vecs: np.ndarray,
    index,
    res=None,
    old_wal_path: Optional[str] = None,
    new_wal=None,
) -> Optional[Tuple[str, int, Optional[str]]]:
    """Install the just-published generation in memory: empty delta,
    empty tombstones, fresh id map, the new generation's WAL as the
    live log. Caller holds ``mut._lock``; the disk state is already
    durable, so this is pure pointer surgery — which is why the
    superseded generation is NOT deleted here. Deleting it is
    corpus-proportional filesystem work (rmtree + WAL unlinks) that
    once ran inside this critical section and stalled every writer and
    searcher behind it; instead the arguments for
    :func:`_cleanup_old_generation` are returned for the caller to run
    *after* releasing the lock (the artifacts are unreferenced the
    moment the manifest flip landed, so when exactly they disappear is
    irrelevant to correctness)."""
    mut._id_loc.clear()
    dim = mut.dim
    mut._delta_data = np.zeros((seg._DELTA_MIN_CAP, dim), np.float32)
    mut._delta_ids = np.full((seg._DELTA_MIN_CAP,), -1, np.int64)
    mut._delta_live = np.zeros((seg._DELTA_MIN_CAP,), bool)
    mut._n_delta = 0
    mut._n_delta_dead = 0
    mut._delta_bf_cache = (-1, None)
    mut._install_main(ids, vecs, index, res=res)
    mut.generation = new_gen
    mut.version += 1
    mut._snap = None
    if mut.directory is not None:
        if mut.wal is not None:
            mut.wal.close()
        if new_wal is not None:
            mut.wal = new_wal
        else:
            mut.wal, _ = seg.WriteAheadLog.open(
                os.path.join(mut.directory, seg._wal_name(new_gen)),
                max_bytes=mut.max_wal_bytes,
            )
        return (mut.directory, new_gen - 1, old_wal_path)
    return None


def _note_compaction(mut: "seg.MutableIndex", mode: str, rows: int, t0: float) -> None:
    if obs.is_enabled():
        obs.inc("mutable.compactions", index=mut.name, mode=mode)
        obs.observe(
            "mutable.compact.duration_ms", (time.perf_counter() - t0) * 1e3,
            index=mut.name,
        )
        obs.observe("mutable.compact.rows", float(rows), index=mut.name)
    mut._note_obs()


def _compact_once(mut: "seg.MutableIndex", res=None) -> int:
    """One synchronous compaction attempt, entirely under the index
    lock (writers and fresh snapshots wait it out)."""
    t0 = time.perf_counter()
    with mut._lock:
        old_gen = mut.generation
        new_gen = old_gen + 1
        ids, vecs = mut.live_rows()
        # chaos seam: a kill here (or anywhere before the manifest flip)
        # has written nothing the old manifest references — pre-state
        faults.fire("compact.merge", generation=new_gen, rows=len(ids))
        # Foreground mode *is* the documented blocking path: the rebuild
        # and artifact writes run with the lock held by design. The
        # off-lock alternative is maintenance.compact_background.
        index = (
            seg._build_main(mut.algo, vecs, mut.index_params, mut.metric,
                            res=res if res is not None else mut.res)
            if len(ids)
            else None
        )
        old_wal_path = mut.wal.path if mut.wal is not None else None
        if mut.directory is not None:
            _clear_stale_wal(os.path.join(mut.directory, seg._wal_name(new_gen)))
            rows_rel, main_rel = _write_generation(mut, new_gen, ids, vecs, index)
            _publish(mut, new_gen, rows_rel, main_rel)
        # the new generation is durable and live on disk — switch memory
        pending_cleanup = _switch_memory(
            mut, new_gen, ids, vecs, index, res=res, old_wal_path=old_wal_path
        )
        _note_compaction(mut, "sync", len(ids), t0)
    # the superseded generation's artifacts are unreferenced once the
    # flip landed — delete them only after releasing the index lock
    if pending_cleanup is not None:
        _cleanup_old_generation(*pending_cleanup)
    return new_gen


def compact(
    mut: "seg.MutableIndex",
    res=None,
    *,
    retry_policy: Optional[RetryPolicy] = None,
    seed: int = 0,
) -> int:
    """Merge ``mut``'s delta + tombstones into a new main segment and
    publish it atomically. Returns the new generation number.

    Transient failures (an injected fault, a flaky filesystem) retry
    with the seeded backoff of :mod:`raft_tpu_torch.robust.retry`, counted in
    ``mutable.compact.retries``; a failed attempt leaves only orphan
    artifacts the next attempt overwrites (and stale new-generation WAL
    segments it clears), so attempts are idempotent. When every attempt
    fails the *last underlying error* is re-raised — callers and chaos
    tests see the real failure, not a ``RetryError`` wrapper.
    """
    policy = retry_policy if retry_policy is not None else COMPACT_RETRY_POLICY
    state = {"attempts": 0}

    def _attempt():
        state["attempts"] += 1
        if state["attempts"] > 1:
            obs.inc("mutable.compact.retries", index=mut.name, mode="sync")
        return _compact_once(mut, res=res)

    # mutex before lock (the compaction lock order): one
    # compaction at a time, foreground or background
    with mut._compact_mutex:
        try:
            return retry_call(_attempt, policy=policy, op="mutable.compact", seed=seed)
        except RetryError as e:
            raise e.last from e


def _cleanup_old_generation(directory: str, old_gen: int, old_wal_path) -> None:
    """Best-effort removal of the superseded generation's artifacts —
    they are unreferenced once the manifest flip landed, so a failure
    here only leaks disk (recovery ignores orphans)."""
    try:
        old_dir = os.path.join(directory, seg._gen_dirname(old_gen))
        if os.path.isdir(old_dir):
            shutil.rmtree(old_dir)
        if old_wal_path:
            # the base file plus every rotated .NNNNNN segment
            for sp in segment_paths(old_wal_path):
                os.unlink(sp)
    except OSError:  # orphan cleanup is advisory
        pass
