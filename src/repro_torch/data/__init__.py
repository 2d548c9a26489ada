"""Synthetic data pipelines (numpy-only copies of the reference's)."""
