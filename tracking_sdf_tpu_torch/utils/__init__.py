"""Timing and tracing helpers."""
