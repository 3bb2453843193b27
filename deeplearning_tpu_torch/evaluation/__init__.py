"""Evaluation helpers of the port (top-k counts in this slice)."""
