"""Process-local metrics."""
