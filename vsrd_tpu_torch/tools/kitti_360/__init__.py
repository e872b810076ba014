"""The pseudo-label tools for KITTI-360: frame sampling, prediction JSONs
from the labeling checkpoints, and their KITTI txt labels."""
