"""Plain references the benchmark holds the code under test to; nothing
here imports the code under test or JAX."""
