"""The SRCNN model (see :mod:`.srcnn`)."""

from .srcnn import SRCNN955

__all__ = ["SRCNN955"]
