"""Losses outside the optimization step (library API)."""
