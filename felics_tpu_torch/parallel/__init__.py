"""The FLCT container on PyTorch: host layout, device chains and batching."""
