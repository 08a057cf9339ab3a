"""Core: errors, resources, serialization, bitsets."""
