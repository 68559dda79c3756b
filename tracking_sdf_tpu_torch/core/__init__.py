"""Lie-group pose algebra and the pinhole camera."""
