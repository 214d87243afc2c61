"""Evaluation sets of the port."""
