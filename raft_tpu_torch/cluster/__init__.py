"""Clustering: k-means and balanced k-means."""
