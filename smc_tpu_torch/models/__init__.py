"""Models (PyTorch)."""
