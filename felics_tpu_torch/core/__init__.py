"""The FLCS single-stream codec on PyTorch: encode, the scan decoder and containers."""
