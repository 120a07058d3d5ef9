"""Persistence helpers of the port (copies of the reference's
``repro/store_io`` pieces it needs, with the same on-disk formats).

* :mod:`repro_torch.store_io.atomic` — atomic-rename JSON, checksummed
  manifests and ``.npy`` segments, advisory file locks;
* :mod:`repro_torch.store_io.graphstore_io` — the on-disk layout behind
  :meth:`repro_torch.ged.GraphStore.save` / ``open``: generation
  directories, the append/delete journal and compaction;
* :mod:`repro_torch.store_io.shared_cache` — :class:`SharedResultCache`,
  the file-locked cross-process LRU of certified GED scalars behind the
  engine's in-memory result cache (``GedEngine(shared_cache_dir=...)``).
"""

from repro_torch.store_io.atomic import (CorruptStoreError, SchemaVersionError,
                                         StoreIOError)
from repro_torch.store_io.shared_cache import (SHARED_CACHE_ENV,
                                               SharedResultCache)

__all__ = [
    "StoreIOError",
    "CorruptStoreError",
    "SchemaVersionError",
    "SharedResultCache",
    "SHARED_CACHE_ENV",
]
