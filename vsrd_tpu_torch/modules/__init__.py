"""Attention modules of the detector leg."""
