"""Evaluation metrics: pose errors and sequence reports (torch), detection
evaluation (a numpy copy of skix's)."""
