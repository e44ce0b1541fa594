"""Stage entry points."""
