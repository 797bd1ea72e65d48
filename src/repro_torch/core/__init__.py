"""Numerics, wire format and quantization policy of the PyTorch port."""
