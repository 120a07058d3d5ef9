"""Atomic JSON files: the write path of the port's tuning table.

A copy of the atomic-JSON layer of the reference's
``repro/store_io/atomic.py`` (``atomic_write_bytes``,
``atomic_write_json``, ``read_json_or_none``), so a ``tuning.json``
written by either package reads the same in the other.  Writes go to a
same-directory temp file and ``os.replace`` into place: readers see the old
bytes or the new bytes, never a torn write.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

__all__ = ["atomic_write_bytes", "atomic_write_json", "read_json_or_none"]


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
