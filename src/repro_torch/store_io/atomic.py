"""The atomic-IO core under the port's persistence paths.

A copy of the reference's ``repro/store_io/atomic.py``, so a file written
by either package reads the same in the other:

* **Atomic JSON** (:func:`atomic_write_json` / :func:`read_json_or_none`)
  — write to a same-directory temp file, ``os.replace`` into place.
  Readers see the old bytes or the new bytes, never a torn write.  The
  tuning table (``tuning.json``) and the shared result cache's entries
  go through it.
* **Checksummed, schema-versioned manifests** (:func:`write_manifest` /
  :func:`read_manifest`) — the JSON layer plus an envelope
  ``{kind, version, checksum, payload}``.  Alien kinds and version bumps
  raise :class:`SchemaVersionError`, bit rot raises
  :class:`CorruptStoreError`.
* **Checksummed ``.npy`` segments** (:func:`write_array` /
  :func:`read_array`) — one array per plain ``.npy`` file, verified
  against its size and BLAKE2b digest before it is mapped.
* **Advisory file locks** (:func:`file_lock`) — ``fcntl`` mutual
  exclusion for multi-process writers (the shared result cache's
  eviction sweeps).  Readers never need the lock: every write above is
  atomic-rename.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import time
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = [
    "StoreIOError", "CorruptStoreError", "SchemaVersionError",
    "LockTimeout",
    "atomic_write_bytes", "atomic_write_json", "read_json_or_none",
    "write_manifest", "read_manifest", "write_array", "read_array",
    "file_lock", "checksum_bytes", "checksum_file",
]


class StoreIOError(RuntimeError):
    """Base class for persistence failures callers may recover from."""


class LockTimeout(StoreIOError):
    """:func:`file_lock` could not acquire the lock within ``timeout``.

    A peer process died (or stalled) holding the advisory lock.  Callers
    decide the policy — the shared result cache fails *open* (skips the
    eviction sweep, still writes atomically) so one dead peer cannot
    wedge every engine process on the machine.
    """


class CorruptStoreError(StoreIOError):
    """A segment or manifest failed its checksum / structure check."""


class SchemaVersionError(StoreIOError):
    """On-disk schema is a kind/version this code does not understand."""


# ------------------------------------------------------------- primitives

def checksum_bytes(data: bytes) -> str:
    """BLAKE2b-128 hex digest of ``data``.

    >>> checksum_bytes(b"")
    'cae66941d9efbd404e4d88758ea67670'
    """
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def checksum_file(path: str, chunk: int = 1 << 20) -> str:
    """Streaming BLAKE2b of a file (segments may be large; never slurp)."""
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-all-or-nothing: temp file in the target directory, fsync,
    ``os.replace``.  Readers of ``path`` never observe a partial write."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_json(path: str, payload, *, indent: int = 1,
                      sort_keys: bool = True) -> None:
    """Atomically persist ``payload`` as JSON, exactly as given (no
    envelope) — the ``tuning.json`` write path.

    >>> import tempfile, os
    >>> p = os.path.join(tempfile.mkdtemp(), "t.json")
    >>> atomic_write_json(p, {"version": 1, "entries": {}})
    >>> read_json_or_none(p)
    {'entries': {}, 'version': 1}
    """
    text = json.dumps(payload, indent=indent, sort_keys=sort_keys)
    atomic_write_bytes(path, text.encode("utf-8"))


def read_json_or_none(path: str):
    """Parse a JSON file; *any* problem (missing, unreadable, torn by a
    non-atomic writer, not JSON) comes back as ``None`` — the
    "corrupt files recover to empty" contract of the tuning table."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ----------------------------------------------- schema'd manifest layer

def write_manifest(path: str, payload, *, kind: str, version: int) -> None:
    """Atomic JSON with a ``{kind, version, checksum, payload}`` envelope.

    The checksum covers the canonical serialization of ``payload`` so a
    partially-flipped manifest cannot masquerade as valid.

    >>> import tempfile, os
    >>> p = os.path.join(tempfile.mkdtemp(), "m.json")
    >>> write_manifest(p, {"a": 1}, kind="demo", version=1)
    >>> read_manifest(p, kind="demo", version=1)
    {'a': 1}
    """
    body = json.dumps(payload, sort_keys=True)
    atomic_write_json(path, {
        "kind": kind,
        "version": int(version),
        "checksum": checksum_bytes(body.encode("utf-8")),
        "payload": payload,
    })


def read_manifest(path: str, *, kind: str, version: int):
    """Validated manifest payload.

    Raises :class:`CorruptStoreError` when the file is missing, not
    JSON, structurally alien, or fails its checksum;
    :class:`SchemaVersionError` when kind/version say "written by other
    code" — distinct, because a version bump is not bit rot.
    """
    raw = read_json_or_none(path)
    if raw is None:
        raise CorruptStoreError(f"manifest {path!r} is missing or unreadable")
    if not isinstance(raw, dict) or "payload" not in raw:
        raise CorruptStoreError(f"manifest {path!r} has no payload envelope")
    if raw.get("kind") != kind or raw.get("version") != version:
        raise SchemaVersionError(
            f"manifest {path!r} is kind={raw.get('kind')!r} "
            f"version={raw.get('version')!r}; this code reads "
            f"kind={kind!r} version={version}")
    body = json.dumps(raw["payload"], sort_keys=True)
    if raw.get("checksum") != checksum_bytes(body.encode("utf-8")):
        raise CorruptStoreError(f"manifest {path!r} failed its checksum")
    return raw["payload"]


# -------------------------------------------------------- array segments

def write_array(directory: str, name: str, arr: np.ndarray) -> Dict:
    """Persist one array as an atomic ``.npy`` segment; returns its
    manifest entry (``{"file", "bytes", "checksum"}``).

    Plain ``.npy`` (not ``.npz``) so :func:`read_array` can hand back an
    ``mmap``-backed view.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=name + ".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, np.ascontiguousarray(arr), allow_pickle=False)
            f.flush()
            os.fsync(f.fileno())
        entry = {"file": name, "bytes": os.path.getsize(tmp),
                 "checksum": checksum_file(tmp)}
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return entry


def read_array(directory: str, entry: Dict, *,
               mmap: bool = True) -> np.ndarray:
    """Load a segment written by :func:`write_array`, verifying size and
    checksum first.  A truncated or bit-flipped segment raises
    :class:`CorruptStoreError` — never a silently-wrong array."""
    try:
        name = entry["file"]
    except (TypeError, KeyError):
        raise CorruptStoreError(f"malformed segment entry {entry!r}")
    path = os.path.join(directory, name)
    try:
        size = os.path.getsize(path)
    except OSError:
        raise CorruptStoreError(f"segment {path!r} is missing")
    if size != entry.get("bytes"):
        raise CorruptStoreError(
            f"segment {path!r} is {size} bytes; manifest says "
            f"{entry.get('bytes')} (truncated write?)")
    if checksum_file(path) != entry.get("checksum"):
        raise CorruptStoreError(f"segment {path!r} failed its checksum")
    try:
        return np.load(path, mmap_mode="r" if mmap else None,
                       allow_pickle=False)
    except ValueError as e:
        raise CorruptStoreError(f"segment {path!r} is not a .npy: {e}")


# ---------------------------------------------------------------- locking

@contextlib.contextmanager
def file_lock(path: str, timeout: Optional[float] = None,
              poll_s: float = 0.02) -> Iterator[None]:
    """Advisory exclusive lock on ``path`` (created if absent).

    POSIX ``fcntl.flock``; on platforms without ``fcntl`` the lock is a
    no-op — single-process use stays correct either way, because every
    write under the lock is itself atomic-rename.

    ``timeout=None`` blocks indefinitely; a finite ``timeout`` polls
    non-blocking acquisitions every ``poll_s`` seconds and raises
    :class:`LockTimeout` when the budget runs out, so a peer that died
    holding the lock costs a bounded wait, not a hang.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        import fcntl
    except ImportError:                                 # pragma: no cover
        yield
        return
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        if timeout is None:
            fcntl.flock(fd, fcntl.LOCK_EX)
        else:
            t_end = time.monotonic() + float(timeout)
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except OSError:
                    if time.monotonic() >= t_end:
                        raise LockTimeout(
                            f"could not acquire {path!r} within "
                            f"{timeout:g}s (peer died holding it?)")
                    time.sleep(min(poll_s, max(0.0,
                                               t_end - time.monotonic())))
        yield
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
