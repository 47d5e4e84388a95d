"""Bag dataset, bucketed batching and the synthetic dataset writer."""
