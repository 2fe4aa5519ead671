"""Evaluation: metrics and the full-split evaluator."""
