"""Small shared tools: paths, pickles, metric log."""
