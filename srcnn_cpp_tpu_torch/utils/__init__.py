"""Framework-free helpers: timing and exit codes."""
