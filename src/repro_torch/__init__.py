"""PyTorch + CUDA port of the TOAST reproduction (see README, PyTorch port)."""
