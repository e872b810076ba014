"""Geometry, box IoU, matching and sampling ops on torch tensors."""
