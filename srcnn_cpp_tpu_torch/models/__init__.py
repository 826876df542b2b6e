"""The SRCNN models (see :mod:`.srcnn`)."""

from .srcnn import SRCNN, SRCNN955

__all__ = ["SRCNN", "SRCNN955"]
