"""The port's model zoo (smallcnn so far)."""

from fedtpu_torch.models import smallcnn  # noqa: F401  (registers "smallcnn")
from fedtpu_torch.models.registry import available, create

__all__ = ["available", "create"]
