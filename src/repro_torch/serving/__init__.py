"""Serving over the port's GED facade: :class:`GedVerificationService`
(pairwise certified verification, with corpus routing once a corpus is
registered) and :class:`GedSimilarityService` (range / k-NN search over a
:class:`repro_torch.ged.GraphStore`), both behind an admission budget.
The reference's ``generate`` (LM decode) belongs to the LM substrate,
which is not ported (``ROADMAP.md``, queue 1)."""

from repro_torch.serving.ged_service import (GedRequest, GedSimilarityService,
                                             GedVerificationService,
                                             SearchRequest)

__all__ = ["GedVerificationService", "GedSimilarityService", "GedRequest",
           "SearchRequest"]
