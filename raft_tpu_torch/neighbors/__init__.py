"""Index families: brute force, IVF-Flat, IVF-PQ, CAGRA (with NN-descent), refine."""
