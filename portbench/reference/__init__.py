"""The plain reference the benchmark holds the system's records to.

Plain NumPy and PyTorch only: nothing here imports the system under test
or JAX, and nothing here reads what the system made."""
