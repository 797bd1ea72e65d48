"""The port's hand-written CUDA kernels, their plain PyTorch versions, and the
dispatch layer (``ops``) the model calls."""
