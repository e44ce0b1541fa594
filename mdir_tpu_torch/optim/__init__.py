"""Retrieval scores."""
