"""Async, atomic checkpoints with elastic restore, in the reference's
on-disk layout (``repro/checkpoint/manager.py``).

Layout (two-phase commit: a crash mid-write can never corrupt a step)::

    <dir>/step_00000100.tmp-<nonce>/     # written first
        manifest.json                    # leaf keys, shapes, dtypes,
                                         # extra metadata, n_hosts
        host0000.npz                     # every leaf, by key
    <dir>/step_00000100/                 # atomic rename on completion

Leaf keys are the reference's: the path of the leaf in the tree, dict
keys in sorted order and tuple/list indices as ``"0"``, ``"1"``, joined
by ``/``, so a ``(params, opt)`` state writes ``0/embed``, ``1/m/embed``,
``1/step`` and so on.  A step directory written by either package
restores in the other.  The port is one process, so it writes one host
file.

``save`` copies every leaf to host memory before it returns: the
optimizer updates parameters in place (the reference's donated buffers),
so a lazy copy would race the next step.  ``save(..., block=False)`` then
hands the serialisation to a background thread; ``wait()`` joins it and
raises a writer's error.  ``keep_last_k`` garbage-collects old steps after
each commit.  ``restore`` re-places every leaf on the device it is given
(one device, or a tree of devices shaped like the template), whatever the
devices were at save time: the elastic restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` in the reference's order and key format."""
    if isinstance(tree, dict):
        children = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        children = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for k, v in children:
        yield from _flatten(v, f"{prefix}/{k}" if prefix else k)


def _rebuild(template: Any, fn, prefix: str = "") -> Any:
    """``template``'s structure with ``fn(key, leaf)`` at every leaf."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(template, dict):
        return {k: _rebuild(v, fn, key(k)) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, fn, key(i))
                              for i, v in enumerate(template))
    return fn(prefix, template)


def _host_copy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype for the "
                            "reference's npz layout")
        return t.cpu().numpy() if t.device.type != "cpu" \
            else t.numpy().copy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory, keep_last_k: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last_k = keep_last_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        self.wait()                       # one in-flight save at a time
        host_items = [(k, _host_copy(leaf)) for k, leaf in _flatten(tree)]
        meta = {
            "step": int(step),
            "keys": [k for k, _ in host_items],
            "shapes": {k: list(v.shape) for k, v in host_items},
            "dtypes": {k: str(v.dtype) for k, v in host_items},
            "extra": extra or {},
            "time": time.time(),
            "n_hosts": 1,
        }
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_items, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_items, meta)

    def _write(self, step: int, host_items, meta) -> None:
        try:
            tmp = self.dir / f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
            tmp.mkdir(parents=True)
            (tmp / "manifest.json").write_text(json.dumps(meta, indent=1))
            np.savez(tmp / "host0000.npz", **dict(host_items))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)         # atomic commit
            self._gc()
        except BaseException as e:        # surfaced on the next wait()
            self._error = e

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last_k] if self.keep_last_k else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err}")

    # ---------------------------------------------------------- restore

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") \
                    and ".tmp-" not in p.name:
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[int, Any, Dict]:
        """Rebuild a ``template``-structured tree of tensors.

        ``shardings`` stands in for the reference's shardings: ``None``
        puts each leaf on its template leaf's device (the CPU for a leaf
        that is not a tensor), a device puts every leaf there, and a tree
        of devices with the template's structure places leaf by leaf.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "manifest.json").read_text())
        data: Dict[str, np.ndarray] = {}
        for f in sorted(d.glob("host*.npz")):
            with np.load(f) as z:
                for k in z.files:
                    data[k] = z[k]
        if shardings is None or isinstance(shardings, (str, torch.device)):
            devices = None
        else:
            devices = dict(_flatten(shardings))

        def leaf(key, tmpl):
            if key not in data:
                raise KeyError(f"checkpoint {step} missing leaf {key!r}")
            arr = data.pop(key)
            want = tuple(getattr(tmpl, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != "
                    f"template {want}")
            if devices is not None:
                dev = devices[key]
            elif shardings is not None:
                dev = shardings
            else:
                dev = getattr(tmpl, "device", "cpu")
            return torch.from_numpy(arr).to(dev)
        return step, _rebuild(template, leaf), meta.get("extra", {})
