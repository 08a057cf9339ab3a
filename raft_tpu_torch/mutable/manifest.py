"""Generation manifest: the single pointer that names the live index
(``raft_tpu.mutable.manifest`` counterpart; the same JSON, so a directory
written by either package opens in the other).

A mutable index directory holds *immutable* generation artifacts
(``gen-NNNNNNNN/`` snapshot dirs, per-generation WAL files) plus one
mutable file — ``MANIFEST.json`` — that names which generation is live.
Every artifact a manifest references is fully written and fsync'd
*before* the manifest swaps to it, and the swap itself is the v4
temp-fsync-rename idiom, so a crash at any instruction leaves the
directory loadable as either the old or the new generation — never a
hybrid. Compaction (:mod:`raft_tpu_torch.mutable.compact`) is its only
writer.

The chaos seam ``manifest.swap`` (:mod:`raft_tpu_torch.robust.faults`)
fires after the temp manifest is durable but before the rename: a kill
there recovers as the *old* generation.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from raft_tpu_torch.robust import faults

FILENAME = "MANIFEST.json"
FORMAT = 1


@dataclasses.dataclass(frozen=True)
class Manifest:
    """The live-generation pointer for one mutable index directory."""

    generation: int
    algo: str
    dim: int
    #: dir-relative path of the main-segment snapshot (None = empty main)
    main: Optional[str]
    #: dir-relative path of the raw-rows sidecar backing the main segment
    rows: Optional[str]
    #: dir-relative path of this generation's write-ahead log
    wal: str
    #: next auto-assigned global id as of this generation's compaction
    next_id: int = 0
    format: int = FORMAT

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Manifest":
        doc = json.loads(text)
        if doc.get("format", 0) > FORMAT:
            raise ValueError(
                f"manifest format {doc.get('format')} is newer than supported {FORMAT}"
            )
        return Manifest(
            generation=int(doc["generation"]),
            algo=str(doc["algo"]),
            dim=int(doc["dim"]),
            main=doc.get("main"),
            rows=doc.get("rows"),
            wal=str(doc["wal"]),
            next_id=int(doc.get("next_id", 0)),
            format=int(doc.get("format", FORMAT)),
        )


def read(directory: str) -> Optional[Manifest]:
    """Load the live manifest, or None when the directory is fresh."""
    path = os.path.join(directory, FILENAME)
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        return Manifest.from_json(f.read())


def swap(directory: str, manifest: Manifest) -> str:
    """Atomically publish ``manifest`` as the live generation.

    Temp-write + fsync + rename, with the ``manifest.swap`` fault seam
    between durability and visibility: everything the new manifest
    points at must already be on disk when this is called.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, FILENAME)
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(manifest.to_json())
            f.flush()
            os.fsync(f.fileno())
        # chaos seam: a kill here leaves the old manifest live — the new
        # generation's files are orphans, not corruption
        faults.fire("manifest.swap", generation=manifest.generation)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
