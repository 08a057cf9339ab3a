"""Layout helpers."""
