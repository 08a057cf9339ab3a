"""Runtime lock-witness: dynamic validation of the lock-order manifest
(``raft_tpu.utils.lockcheck`` counterpart).

Tracked locks record the acquisition edges real threads actually take,
and each edge is asserted against the port's own manifest,
``raft_tpu_torch/utils/lock_order.toml``, which declares the locks the
port creates (``mutable.lock``, ``mutable.compact_mutex``,
``compactor.state``, ``obs.registry``, ``robust.faults``), the edges
permitted between them and the fields each guards.

Gated by ``RAFT_TPU_LOCKCHECK`` (default **off**), like the
``RAFT_TPU_OBS`` / ``RAFT_TPU_FAULTS`` switches. Off is zero-cost:
:func:`tracked` returns the raw lock object untouched, so production
code pays nothing, not even a wrapper ``__enter__``. On, every tracked
acquisition walks the thread's held-lock stack and records one
``(held, acquired)`` edge per distinct held lock.

Because the gate is evaluated when the lock is **created**, enable the
witness (env var or :func:`enable`) before constructing the objects
whose locks you want tracked. Module-global locks (the default obs
registry, the default fault registry) are created at import time, so
full-coverage runs set ``RAFT_TPU_LOCKCHECK=1`` in the environment
before the process starts.

The manifest is read with ``tomllib`` when importable, else with a
minimal TOML subset reader. A missing manifest degrades to record-only
mode: edges are still collected (``edges()``), nothing is flagged.
"""
from __future__ import annotations

import functools
import os
import sys
import threading
import types
from typing import Dict, List, Optional, Set, Tuple

_TRUTHY = ("1", "true", "on", "yes")

_enabled = os.environ.get("RAFT_TPU_LOCKCHECK", "0").strip().lower() in _TRUTHY

#: override the manifest location (else: lock_order.toml beside this file)
_MANIFEST_ENV = "RAFT_TPU_LOCKCHECK_MANIFEST"


def enable(flag: bool = True) -> None:
    """Turn the witness on/off for locks created *after* this call."""
    global _enabled
    _enabled = bool(flag)


def disable() -> None:
    enable(False)


def is_enabled() -> bool:
    return _enabled


# -- manifest ----------------------------------------------------------------


def _parse_toml_subset(text: str) -> dict:
    """A TOML subset reader: top-level ``key = value``, ``[[table]]``
    sections, string/bool/int/string-array values. Enough for
    lock_order.toml, dependency-free."""
    root: dict = {}
    current = root

    def _value(raw: str):
        raw = raw.strip()
        if raw.startswith("["):
            return [
                _value(p) for p in raw[1:-1].split(",") if p.strip()
            ]
        if raw.startswith('"') and raw.endswith('"'):
            return raw[1:-1]
        if raw in ("true", "false"):
            return raw == "true"
        try:
            return int(raw)
        except ValueError:
            return raw

    for line in text.splitlines():
        if "#" in line:
            line = line.split("#", 1)[0]
        line = line.strip()
        if not line:
            continue
        if line.startswith("[[") and line.endswith("]]"):
            current = {}
            root.setdefault(line[2:-2].strip(), []).append(current)
        elif line.startswith("[") and line.endswith("]"):
            current = root.setdefault(line[1:-1].strip(), {})
        elif "=" in line:
            key, raw = line.split("=", 1)
            current[key.strip()] = _value(raw)
    return root


def _load_toml(path: str) -> dict:
    with open(path, "rb") as f:
        text = f.read().decode("utf-8")
    try:
        import tomllib
    except ImportError:
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ImportError:
            return _parse_toml_subset(text)
    return tomllib.loads(text)


def default_manifest_path() -> Optional[str]:
    """The port's ``lock_order.toml`` beside this module, or the
    ``RAFT_TPU_LOCKCHECK_MANIFEST`` override; None when neither exists
    (record-only mode)."""
    override = os.environ.get(_MANIFEST_ENV)
    if override:
        return override if os.path.isfile(override) else None
    cand = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lock_order.toml")
    return cand if os.path.isfile(cand) else None


class _Manifest:
    """Declared lock names and permitted edges, as the witness needs
    them (the static pass owns the richer view)."""

    def __init__(self, data: dict):
        self.lock_names: Set[str] = {
            e["name"] for e in data.get("lock", []) if "name" in e
        }
        self.edges: Set[Tuple[str, str]] = {
            (e["from"], e["to"])
            for e in data.get("edge", [])
            if "from" in e and "to" in e
        }
        #: class name -> (lock name, fully guarded fields, write-guarded)
        self.guards: Dict[str, Tuple[str, Tuple[str, ...], Tuple[str, ...]]] = {}
        for e in data.get("guards", []):
            if "class" in e and "lock" in e:
                self.guards[e["class"]] = (
                    e["lock"],
                    tuple(e.get("fields", [])),
                    tuple(e.get("write_guarded", [])),
                )

    def permits(self, held: str, acquired: str) -> bool:
        return held == acquired or (held, acquired) in self.edges


_manifest: Optional[_Manifest] = None
_manifest_loaded = False


def manifest() -> Optional[_Manifest]:
    global _manifest, _manifest_loaded
    if not _manifest_loaded:
        _manifest_loaded = True
        path = default_manifest_path()
        if path is not None:
            try:
                _manifest = _Manifest(_load_toml(path))
            except (OSError, KeyError, TypeError, ValueError):
                _manifest = None  # unreadable manifest -> record-only
    return _manifest


# -- the witness -------------------------------------------------------------

_local = threading.local()            # .held: per-thread acquisition stack
_agg = threading.Lock()               # leaf: guards the aggregates below
_edges: Dict[Tuple[str, str], int] = {}
_violations: List[str] = []
_violation_keys: Set[Tuple[str, str]] = set()


def _held_stack() -> List[str]:
    held = getattr(_local, "held", None)
    if held is None:
        held = _local.held = []
    return held


def _note_acquire(name: str) -> None:
    held = _held_stack()
    man = manifest()
    new_edges = {(h, name) for h in held if h != name}
    if new_edges:
        with _agg:
            for edge in new_edges:
                _edges[edge] = _edges.get(edge, 0) + 1
                if (
                    man is not None
                    and not man.permits(*edge)
                    and edge not in _violation_keys
                ):
                    _violation_keys.add(edge)
                    _violations.append(
                        f"{edge[0]} -> {edge[1]} acquired by thread "
                        f"{threading.current_thread().name!r} is not a "
                        "permitted edge in lock_order.toml"
                    )
    held.append(name)


def _note_release(name: str) -> None:
    held = _held_stack()
    # locks are almost always released LIFO; tolerate out-of-order by
    # removing the most recent matching entry
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class TrackedLock:
    """Context-manager/acquire-release wrapper that witnesses one named
    lock. Delegates to the wrapped primitive, so RLock reentrancy keeps
    working (a re-acquire records no edge: self-edges are skipped)."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name: str):
        self._lock = lock
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _note_acquire(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        _note_release(self.name)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TrackedLock({self.name!r}, {self._lock!r})"


def tracked(lock, name: str):
    """Wrap ``lock`` for witnessing under its canonical manifest name —
    or return it untouched when the witness is off (the zero-cost
    path: no wrapper object, no per-acquire indirection)."""
    if not _enabled:
        return lock
    return TrackedLock(lock, name)


# -- the guarded-field witness ------------------------------------------------
#
# Under RAFT_TPU_LOCKCHECK=1, @guarded_fields installs a data
# descriptor per field the manifest's [[guards]] section declares for
# the class, and
# every access asserts the declared lock is on the accessing thread's
# held stack. Off, the decorator returns the class untouched — raw
# attribute access, no descriptor, zero overhead.
#
# Semantics:
#
# * `fields` check reads and writes; `write_guarded` checks writes only
#   (lock-free reads are the declared bounded-staleness idiom).
# * The __init__ / fresh-object escapes become *creator-thread arming*:
#   the wrapped __init__ records the constructing thread, and
#   enforcement starts only once a second thread touches the instance
#   (it is then "shared" forever). MutableIndex.open() populating a
#   fresh instance never trips it; the known limit is that the second
#   thread's own first racing access is the one that arms, so that
#   single access goes unchecked.
# * Enforcement is scoped to library frames: for a class defined under
#   the raft_tpu_torch package, accesses from outside the package (tests
#   peeking at `mut.generation`) are exempt. Classes defined outside the
#   package (the witness's own unit tests) are enforced from everywhere.
#
# Coverage bookkeeping: a guard is *armed* when its class is
# instantiated during the run, and *exercised* when any access to one
# of its fields is observed with the declared lock held (in enforcement
# scope).

_PKG_PREFIX = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep

_field_violations: List[str] = []
_field_violation_keys: Set[Tuple[str, str, str, int]] = set()
_field_exercised: Set[str] = set()
_field_armed: Set[str] = set()
#: id(instance) -> creating thread ident / shared flag. id() reuse after
#: gc is handled by the wrapped __init__, which re-registers and clears
#: the shared flag before any field of the new instance can be touched.
_instance_owner: Dict[int, int] = {}
_shared_instances: Set[int] = set()


class _GuardedField:
    """Data descriptor asserting the declared lock on field access.
    Dict-backed classes store the value in the instance ``__dict__``
    under the field's own name (the descriptor wins attribute lookup
    because it defines ``__set__``); ``__slots__`` classes delegate to
    the captured member descriptor."""

    __slots__ = ("cls_name", "field", "lock_name", "write_only",
                 "member", "everywhere")

    def __init__(self, cls_name, field, lock_name, write_only, member, everywhere):
        self.cls_name = cls_name
        self.field = field
        self.lock_name = lock_name
        self.write_only = write_only
        self.member = member
        self.everywhere = everywhere

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if not self.write_only:
            self._check(obj, "read")
        if self.member is not None:
            return self.member.__get__(obj, objtype)
        try:
            return obj.__dict__[self.field]
        except KeyError:
            raise AttributeError(
                f"{self.cls_name!r} object has no attribute {self.field!r}"
            ) from None

    def __set__(self, obj, value):
        self._check(obj, "write")
        if self.member is not None:
            self.member.__set__(obj, value)
        else:
            obj.__dict__[self.field] = value

    def __delete__(self, obj):
        self._check(obj, "write")
        if self.member is not None:
            self.member.__delete__(obj)
        else:
            del obj.__dict__[self.field]

    def _check(self, obj, kind: str) -> None:
        frame = sys._getframe(2)
        if not self.everywhere and not frame.f_code.co_filename.startswith(
            _PKG_PREFIX
        ):
            return  # test/tool code peeking at library state: out of scope
        oid = id(obj)
        shared = oid in _shared_instances
        if not shared:
            owner = _instance_owner.get(oid)
            if owner is not None and owner != threading.get_ident():
                _shared_instances.add(oid)
                shared = True
        if self.lock_name in _held_stack():
            with _agg:
                _field_exercised.add(self.cls_name)
            return
        if not shared:
            return  # still owned by its creating thread: construction phase
        key = (self.cls_name, self.field,
               frame.f_code.co_filename, frame.f_lineno)
        with _agg:
            if key not in _field_violation_keys:
                _field_violation_keys.add(key)
                _field_violations.append(
                    f"{kind} of {self.cls_name}.{self.field} at "
                    f"{frame.f_code.co_filename}:{frame.f_lineno} without "
                    f"{self.lock_name!r} held (thread "
                    f"{threading.current_thread().name!r})"
                )


def guarded_fields(cls):
    """Class decorator wiring the manifest's ``[[guards]]`` entry for
    ``cls.__name__`` into runtime assertions. Returns the class
    untouched when the witness is off at class-definition time, when no
    manifest is found, or when the manifest declares nothing for the
    class — so stacking it on every guarded class is free in
    production."""
    if not _enabled:
        return cls
    man = manifest()
    if man is None:
        return cls
    g = man.guards.get(cls.__name__)
    if g is None:
        return cls
    lock_name, fields, write_guarded = g
    mod = sys.modules.get(cls.__module__)
    cls_file = getattr(mod, "__file__", "") or ""
    everywhere = not os.path.abspath(cls_file).startswith(_PKG_PREFIX)
    for field, write_only in (
        [(f, False) for f in fields] + [(f, True) for f in write_guarded]
    ):
        existing = cls.__dict__.get(field)
        member = (
            existing
            if isinstance(existing, types.MemberDescriptorType)
            else None
        )
        setattr(cls, field, _GuardedField(
            cls.__name__, field, lock_name, write_only, member, everywhere,
        ))

    orig_init = cls.__init__

    @functools.wraps(orig_init)
    def _armed_init(self, *args, **kwargs):
        oid = id(self)
        _instance_owner[oid] = threading.get_ident()
        _shared_instances.discard(oid)  # id reuse: this object is fresh
        with _agg:
            _field_armed.add(cls.__name__)
        orig_init(self, *args, **kwargs)

    cls.__init__ = _armed_init
    return cls


# -- reporting ---------------------------------------------------------------


def reset() -> None:
    """Clear recorded edges, violations, and field-witness aggregates
    (held stacks are per-thread and self-balancing; per-instance owner
    bookkeeping survives — instances outlive a reset)."""
    with _agg:
        _edges.clear()
        _violations.clear()
        _violation_keys.clear()
        _field_violations.clear()
        _field_violation_keys.clear()
        _field_exercised.clear()
        _field_armed.clear()


def edges() -> Dict[Tuple[str, str], int]:
    """Observed acquisition edges -> times taken."""
    with _agg:
        return dict(_edges)


def violations() -> List[str]:
    """Edges observed that the manifest does not permit (one entry per
    distinct edge)."""
    with _agg:
        return list(_violations)


def coverage() -> Tuple[Set[Tuple[str, str]], Set[Tuple[str, str]]]:
    """``(exercised, declared)``: which declared manifest edges the run
    actually took. ``declared - exercised`` is the untested contract."""
    man = manifest()
    declared = set(man.edges) if man is not None else set()
    with _agg:
        exercised = declared & set(_edges)
    return exercised, declared


def field_violations() -> List[str]:
    """Guarded-field accesses observed on a shared instance without the
    declared lock held (one entry per distinct access site)."""
    with _agg:
        return list(_field_violations)


def field_coverage() -> Dict[str, Dict[str, bool]]:
    """Per declared guard class: whether the run *armed* it (constructed
    an instance) and *exercised* it (observed a guarded access with the
    declared lock held). ``armed and not exercised`` is a guard the run
    never demonstrated. The dict is JSON-ready."""
    man = manifest()
    declared = set(man.guards) if man is not None else set()
    with _agg:
        out = {
            cls: {
                "armed": cls in _field_armed,
                "exercised": cls in _field_exercised,
            }
            for cls in sorted(declared | _field_armed | _field_exercised)
        }
    return out
