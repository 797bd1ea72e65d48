"""Device selection: the port runs on the GPU unless the caller asks for the
CPU, and never drops to the CPU on its own."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default, and CUDA is not available here; "
            "pass device='cpu' to run the plain PyTorch versions of the kernels on the CPU")
    return dev
