"""Depth preprocessing and Gauss-Newton camera tracking."""
