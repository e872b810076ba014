"""Diagnostic image panels of the labeling driver."""
