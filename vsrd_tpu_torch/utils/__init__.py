"""Conversion helpers."""
