"""Evaluation metrics: pose errors and sequence reports (torch); detection
and tracking evaluation (numpy copies of skix's: AP, MOTA, HOTA, TETA,
cgF1, video instance AP and the suite that combines them)."""
