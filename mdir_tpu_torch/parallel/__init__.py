"""Batched multi-scale descriptor extraction."""
