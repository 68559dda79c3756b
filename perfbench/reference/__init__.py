"""The plain PyTorch reference that decides a run's `correct` (see check.py)."""
