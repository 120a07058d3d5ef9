"""Training optimizers of the port: AdamW with global-norm clipping, the
cosine learning-rate schedule and int8 error-feedback gradient
compression (the reference's ``repro/optim``)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compress import (compress_int8, decompress_int8,
                                        error_feedback_update,
                                        psum_compressed)
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm",
    "cosine_schedule",
    "compress_int8", "decompress_int8", "error_feedback_update",
    "psum_compressed",
]
