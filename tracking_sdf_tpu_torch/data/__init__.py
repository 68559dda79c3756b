"""Synthetic scenes and exact depth rendering."""
