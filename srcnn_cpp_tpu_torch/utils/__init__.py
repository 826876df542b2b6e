"""Framework-free helpers: timing, exit codes and image-quality metrics;
:mod:`.profiling` (imported by name, as in the JAX package) holds the
trace, the stage timer and the MP/s helper."""

from .metrics import psnr, ssim
from .timer import TickTimer, tick_ms

__all__ = ["TickTimer", "tick_ms", "psnr", "ssim"]
