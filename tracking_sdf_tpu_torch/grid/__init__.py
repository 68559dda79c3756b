"""TSDF grid storage, coordinate maps and interpolation."""
