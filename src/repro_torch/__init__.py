"""PyTorch/CUDA port of the RaZeR reproduction (the JAX package ``repro`` is
its reference).

Slice ported so far: RaZeR-packed W4 and W4A4 static serving with the RaZeR
KV cache (``serving.engine.Engine.generate``) over a dense GQA decoder, with
three hand-written CUDA kernels for Hopper under ``csrc/``.  Everything runs
on the GPU unless the caller passes ``device="cpu"``; on the CPU the kernels'
plain PyTorch versions run instead.
"""
