"""Index families: brute force, IVF-Flat, refine."""
