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


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU).  A clock read
    right after work that hands nothing back to the host would otherwise
    time its launch, not its kernels."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
