"""Framework-free helpers: timing, exit codes and image-quality metrics;
:mod:`.profiling` (imported by name, as in the JAX package) holds the
trace and the program's spans."""

from .metrics import psnr, ssim
from .timer import TickTimer, tick_ms

__all__ = ["TickTimer", "tick_ms", "psnr", "ssim"]
