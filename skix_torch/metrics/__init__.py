"""Evaluation metrics (numpy copies of skix's)."""
