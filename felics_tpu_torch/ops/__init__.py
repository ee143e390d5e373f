"""Device ops of the port: the FLCT tile codec kernels and their plain versions."""
