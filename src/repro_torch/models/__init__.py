"""Model substrate of the port: configs, layers and the dense-stack step
functions (``transformer``) that the LM serving path runs."""

from repro_torch.models.config import ArchConfig, reduced

__all__ = ["ArchConfig", "reduced"]
