"""Scenario files: yaml loading and the deep overlay."""
