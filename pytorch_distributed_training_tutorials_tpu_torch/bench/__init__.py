"""Benchmarks of the PyTorch port."""
