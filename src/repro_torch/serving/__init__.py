"""Serving over the port's GED facade: :class:`GedVerificationService`
(pairwise certified verification, with corpus routing once a corpus is
registered) and :class:`GedSimilarityService` (range / k-NN search over a
:class:`repro_torch.ged.GraphStore`), both behind an admission budget;
and :func:`generate`, greedy LM decoding over the dense stack
(``serving/lm_decode.py``)."""

from repro_torch.serving.ged_service import (GedRequest, GedSimilarityService,
                                             GedVerificationService,
                                             SearchRequest)
from repro_torch.serving.lm_decode import generate

__all__ = ["GedVerificationService", "GedSimilarityService", "GedRequest",
           "SearchRequest", "generate"]
