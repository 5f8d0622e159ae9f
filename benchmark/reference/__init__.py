"""The plain reference the benchmark holds the port to: plain PyTorch,
independent of the system under test."""
