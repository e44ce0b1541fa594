"""Retrieval scores, training criteria, optimizers and schedulers."""
