"""Local training."""
