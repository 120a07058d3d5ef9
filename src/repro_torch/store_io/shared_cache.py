"""Cross-process result-cache tier behind the engine's ``ResultCache``.

A copy of the reference's ``repro/store_io/shared_cache.py`` with the same
on-disk format (schema ``v: 1``, one JSON file per entry, the same entry
path), so a directory written by ``repro`` is read by ``repro_torch`` and
the other way round.

The in-memory :class:`repro_torch.ged.exec.ResultCache` dies with its
process; this tier is the durable layer behind it: an on-disk LRU of
**certified scalars only**, keyed on the canonical pair digests
(tau-aware), so a warm process answers pairs an earlier process already
proved.

* **Never a wrong answer.**  Only certified outcomes are admitted, and
  only their scalars (``ged`` / ``similar`` / bounds / ``tau``) are
  stored.  A certificate makes the scalar exact whichever engine config
  or backend produced it, which is why the on-disk key drops the
  in-memory key's config and backend.  Mappings are never stored.
* **Multi-process safe.**  One entry per file, written atomically, so
  readers need no lock.  Writers serialize mutation and eviction sweeps
  through one advisory :func:`~repro_torch.store_io.atomic.file_lock`; a
  corrupt or torn entry reads as a miss, never as data.
* **LRU by access time.**  Reads touch the entry's mtime; the amortized
  eviction sweep (under the lock) drops the oldest entries beyond
  ``max_entries``.  Counters are per process and surface in
  ``engine.stats`` as ``shared_cache_*``.

Wired by ``GedEngine(shared_cache_dir=...)`` or the
``REPRO_GED_SHARED_CACHE_DIR`` environment variable.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import struct
from typing import TYPE_CHECKING, Dict, Optional

from repro_torch.store_io.atomic import (LockTimeout, atomic_write_json,
                                         file_lock, read_json_or_none)

if TYPE_CHECKING:                                  # pragma: no cover
    from repro_torch.ged.results import GedOutcome

__all__ = ["SharedResultCache", "SHARED_CACHE_ENV"]

SHARED_CACHE_ENV = "REPRO_GED_SHARED_CACHE_DIR"
_SCHEMA_VERSION = 1
_INF = float("inf")


def _encode(value: Optional[float]):
    if value is None:
        return None
    value = float(value)
    if value == _INF:
        return "inf"                # JSON has no Infinity literal
    return value


def _decode(value) -> Optional[float]:
    if value is None:
        return None
    if value == "inf":
        return _INF
    return float(value)


class SharedResultCache:
    """On-disk LRU of certified GED scalars, shared across processes.

    ``key`` everywhere below is the engine's in-memory pair key
    (:func:`repro_torch.ged.exec.pair_key`); only its digest/mode/tau
    prefix reaches the disk key.

    >>> import tempfile
    >>> from repro_torch.ged.results import GedOutcome
    >>> cache = SharedResultCache(tempfile.mkdtemp())
    >>> key = ("exact", b"q-digest", b"g-digest", False, None, None, "cuda")
    >>> cache.get(key) is None, cache.misses
    (True, 1)
    >>> out = GedOutcome(ged=2.0, similar=None, certified=True,
    ...                  lower_bound=2.0, upper_bound=2.0, mapping=None,
    ...                  backend="cuda", wall_s=0.01)
    >>> cache.put(key, out)
    True
    >>> hit = cache.get(key)
    >>> hit.ged, hit.certified, hit.backend, cache.hits
    (2.0, True, 'shared-cache', 1)
    """

    def __init__(self, directory: str, max_entries: int = 4096,
                 sweep_every: int = 32, lock_timeout_s: float = 10.0):
        self.directory = str(directory)
        self.max_entries = int(max_entries)
        self.sweep_every = max(int(sweep_every), 1)
        self.lock_timeout_s = (None if lock_timeout_s is None
                               else float(lock_timeout_s))
        os.makedirs(self.directory, exist_ok=True)
        self._lock_path = os.path.join(self.directory, "lock")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.lock_timeouts = 0
        self._puts = 0

    # ---------------------------------------------------------- keying

    def _path(self, key: tuple) -> str:
        # (digest_kind, dq, dg, verification, tau) — the canonical,
        # config-independent prefix of the in-memory pair key.  Both pair
        # orientations map to one entry: GED is symmetric and only
        # scalars are stored.
        digest_kind, dq, dg, verification, tau = key[:5]
        h = hashlib.blake2b(digest_size=16)
        h.update(str(digest_kind).encode("utf-8"))
        for d in sorted((bytes(dq), bytes(dg))):
            h.update(b"\x00")
            h.update(d)
        h.update(b"\x01" if verification else b"\x02")
        h.update(b"none" if tau is None else struct.pack("<d", float(tau)))
        return os.path.join(self.directory, h.hexdigest() + ".json")

    # ----------------------------------------------------------- lookup

    def get(self, key: tuple) -> Optional[GedOutcome]:
        """Certified outcome for ``key``, rebuilt from stored scalars, or
        ``None``.  Reads are lock-free (atomic writes guarantee complete
        files); a hit touches the entry's mtime to mark recency."""
        # imported here: repro_torch.ged imports this module (through
        # GedEngine), so importing the package from here at load time
        # would be circular
        from repro_torch.ged.results import GedOutcome
        path = self._path(key)
        raw = read_json_or_none(path)
        if (not isinstance(raw, dict)
                or raw.get("v") != _SCHEMA_VERSION
                or "lb" not in raw or "ub" not in raw):
            self.misses += 1
            return None
        with contextlib.suppress(OSError):
            os.utime(path)
        self.hits += 1
        return GedOutcome(
            ged=_decode(raw.get("ged")),
            similar=(None if raw.get("similar") is None
                     else bool(raw["similar"])),
            certified=True,
            lower_bound=_decode(raw["lb"]),
            upper_bound=_decode(raw["ub"]),
            mapping=None,
            backend="shared-cache",
            wall_s=0.0,
            tau=_decode(raw.get("tau")),
            stats={"cached": "shared"},
        )

    def put(self, key: tuple, outcome: GedOutcome) -> bool:
        """Admit a *certified* outcome's scalars; returns whether it was
        stored.  Serialized with other writers through the directory
        lock; an amortized LRU sweep keeps the entry count bounded."""
        if not outcome.certified:
            return False
        payload = {
            "v": _SCHEMA_VERSION,
            "ged": _encode(outcome.ged),
            "similar": (None if outcome.similar is None
                        else bool(outcome.similar)),
            "lb": _encode(outcome.lower_bound),
            "ub": _encode(outcome.upper_bound),
            "tau": _encode(outcome.tau),
        }
        try:
            self._check_lock_fault()
            with file_lock(self._lock_path, timeout=self.lock_timeout_s):
                atomic_write_json(self._path(key), payload, indent=0)
                self._puts += 1
                if (self._puts % self.sweep_every == 1
                        or self.sweep_every == 1):
                    self._evict_locked()
        except LockTimeout:
            # Fail open: a peer died holding the lock.  The entry write
            # itself is atomic-rename (safe without the lock); only the
            # eviction sweep needs mutual exclusion, so skip it and count
            # the event (shared_cache_lock_timeouts).
            self.lock_timeouts += 1
            # lazy import: this module must stay importable without
            # repro_torch.ged, which imports it
            from repro_torch.ged.faults import warn_once
            warn_once("shared-cache-lock",
                      f"shared result cache lock {self._lock_path!r} "
                      f"timed out after {self.lock_timeout_s:g}s; "
                      "writing without eviction sweep (fail-open)")
            atomic_write_json(self._path(key), payload, indent=0)
        return True

    def _check_lock_fault(self) -> None:
        """The ``lock`` fault site: an injected fault simulates a dead
        peer by raising the timeout path directly (lazy import: this
        module must stay importable without ``repro_torch.ged``)."""
        from repro_torch.ged.faults import get_injector
        inj = get_injector()
        if inj is not None:
            try:
                inj.check("lock")
            except Exception as exc:
                raise LockTimeout(
                    f"injected lock timeout on {self._lock_path!r}"
                ) from exc

    def entries(self) -> int:
        """Current on-disk entry count (directory scan; stats path only)."""
        try:
            with os.scandir(self.directory) as it:
                return sum(1 for e in it if e.name.endswith(".json"))
        except OSError:
            return 0

    @property
    def stats(self) -> Dict[str, float]:
        return {"hits": float(self.hits), "misses": float(self.misses),
                "evictions": float(self.evictions),
                "lock_timeouts": float(self.lock_timeouts)}

    # --------------------------------------------------------- internal

    def _evict_locked(self) -> None:
        """Drop oldest-accessed entries beyond ``max_entries`` (caller
        holds the lock).  Concurrent deletions are benign — a vanished
        file is skipped, a re-read after eviction is just a miss."""
        try:
            with os.scandir(self.directory) as it:
                rows = [(e.stat().st_mtime, e.path) for e in it
                        if e.name.endswith(".json")]
        except OSError:
            return
        excess = len(rows) - self.max_entries
        if excess <= 0:
            return
        rows.sort()
        for _, path in rows[:excess]:
            with contextlib.suppress(OSError):
                os.unlink(path)
                self.evictions += 1
