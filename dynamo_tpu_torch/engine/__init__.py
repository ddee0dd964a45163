"""Serving engine of the port: allocator, sampling, weights, TorchEngine."""
