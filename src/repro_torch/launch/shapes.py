"""Assigned input shapes and abstract ``input_specs()`` per (arch, shape).

The reference's ``repro/launch/shapes.py``.  Every cell of the
(architecture x shape) grid is defined here.  Specs are ``meta`` tensors
(the reference's ``jax.ShapeDtypeStruct``: shapes and dtypes, never
allocated), consumed by ``launch/dryrun.py`` and, with concrete tensors of
the same shapes, by the real train/serve steps of ``launch/steps.py``.

LM shapes (seq_len x global_batch):
  train_4k     4,096 x 256   -> ``train_step``
  prefill_32k  32,768 x 32   -> ``prefill_step``
  decode_32k   32,768 x 128  -> ``decode_step`` (1 new token, 32k KV/state)
  long_500k    524,288 x 1   -> ``decode_step`` (sub-quadratic archs only)

GED engine rows (the paper's technique on the same mesh):
  ged-verify / ged-compute, pair batch scaled to 128 pairs/chip.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    subquadratic_only: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1,
                           subquadratic_only=True),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs; otherwise the documented skip reason."""
    if shape.subquadratic_only and not cfg.subquadratic:
        return "skipped (full attention; long_500k needs sub-quadratic)"
    return None


def _sds(shape: Tuple[int, ...], dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract model inputs for one grid cell.

    train   -> {tokens, labels[, patches|frames][, pos]}
    prefill -> {tokens[, patches|frames][, pos]}
    decode  -> {token, cache_len}   (caches are built separately)
    """
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    if shape.kind == "decode":
        return {"token": _sds((b, 1), i32),
                "cache_len": _sds((), i32)}

    specs: Dict[str, Any] = {}
    if cfg.vlm is not None:
        # patches are part of the stream: text tokens fill the rest so the
        # total stream length is exactly ``seq_len``.
        p = cfg.vlm.num_patches
        text = s - p
        specs["tokens"] = _sds((b, text), i32)
        specs["patches"] = _sds((b, p, cfg.d_model), bf16)
        if shape.kind == "train":
            specs["labels"] = _sds((b, text), i32)
        return specs

    if cfg.family == "audio":
        specs["frames"] = _sds((b, cfg.encdec.enc_seq, cfg.d_model), bf16)
        specs["tokens"] = _sds((b, s), i32)
        if shape.kind == "train":
            specs["labels"] = _sds((b, s), i32)
        return specs

    specs["tokens"] = _sds((b, s), i32)
    if shape.kind == "train":
        specs["labels"] = _sds((b, s), i32)
    return specs


# ------------------------------------------------------------- GED rows

@dataclasses.dataclass(frozen=True)
class GedShapeSpec:
    name: str
    verification: bool
    pairs_per_chip: int
    slots: int              # padded vertex capacity N
    pool: int
    expand: int
    max_iters: int
    sweeps: int


GED_SHAPES: Dict[str, GedShapeSpec] = {
    # Graph-similarity-search verification: the paper's §5.3 workload.
    "verify_db": GedShapeSpec("verify_db", True, 128, 32, 256, 4, 128, 6),
    # Exact computation (heavier per pair, fewer pairs).
    "compute": GedShapeSpec("compute", False, 32, 32, 512, 8, 256, 8),
}

GED_ARCHS = ("ged-verify", "ged-compute")


def ged_input_specs(spec: GedShapeSpec, n_chips: int) -> Dict[str, Any]:
    b = spec.pairs_per_chip * n_chips
    n = spec.slots
    i32 = torch.int32
    return dict(
        qv=_sds((b, n), i32),
        gv=_sds((b, n), i32),
        qa=_sds((b, n, n), i32),
        ga=_sds((b, n, n), i32),
        order=_sds((b, n), i32),
        n=_sds((b,), i32),
        taus=_sds((b,), torch.float32),
    )
