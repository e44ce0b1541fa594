"""Batched multi-scale descriptor extraction and batched translation."""
