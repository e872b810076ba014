"""Learnable box parameters and the hypernetwork field."""
