"""The port's model zoo (smallcnn and MobileNet so far)."""

from fedtpu_torch.models import mobilenet, smallcnn  # noqa: F401  (register themselves)
from fedtpu_torch.models.registry import available, create

__all__ = ["available", "create"]
