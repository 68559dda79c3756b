"""Trajectory I/O and metrics, and the end-to-end frame loop."""
