"""Runtime helpers."""
