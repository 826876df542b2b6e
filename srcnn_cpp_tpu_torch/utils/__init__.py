"""Framework-free helpers: timing, exit codes and image-quality metrics."""
