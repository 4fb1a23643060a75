"""Synthetic data in the training-batch schema."""
