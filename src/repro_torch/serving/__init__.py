"""Serving side of the PyTorch port: the packed KV cache and the static
``Engine.generate``."""
