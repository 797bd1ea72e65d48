"""AWQ-style activation-aware weight scaling (Lin et al. 2024b), the
paper's Table 8 combination study (AWQ + {INT4, FP4, RaZeR}); PyTorch port
of ``repro.core.awq``.

AWQ protects the weight channels that see large activations by scaling them
up before quantization and folding the inverse scale into the activation
path:

    W' = W * s[:, None],   x' = x / s,   s = a_stat^alpha

alpha is grid-searched to minimize the quantized layer's output MSE on a
calibration batch.  Offline PTQ, on the weight's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

__all__ = ["AWQResult", "awq_search", "apply_awq"]


@dataclass
class AWQResult:
    scales: torch.Tensor  # (d_in,) per-input-channel weight multiplier
    alpha: float
    out_mse: float


def awq_search(w: torch.Tensor, calib_x, quantize_fn: Callable,
               alphas: Sequence[float] = tuple(i / 10 for i in range(0, 11))) -> AWQResult:
    """Grid-search the AWQ exponent for one (d_in, d_out) layer.

    ``quantize_fn(w) -> w_hat`` is any of the port's quantizers blocked
    along axis 0, so AWQ composes with INT4 / FP4 / RaZeR as in Table 8.
    The first alpha of the lowest MSE wins."""
    x = torch.as_tensor(calib_x, device=w.device).reshape(-1, w.shape[0])
    a_stat = x.abs().mean(dim=0) + 1e-8  # (d_in,)
    ref = x @ w
    best = None
    for alpha in alphas:
        s = a_stat ** alpha
        s = s / torch.sqrt(s.max() * s.min())  # normalized around 1 (the AWQ trick)
        w_hat = quantize_fn(w * s[:, None]) / s[:, None]
        mse = float(((x @ w_hat - ref) ** 2).mean())
        if best is None or mse < best.out_mse:
            best = AWQResult(scales=s, alpha=float(alpha), out_mse=mse)
    return best


def apply_awq(w: torch.Tensor, result: AWQResult, quantize_fn: Callable) -> torch.Tensor:
    """The dequantized AWQ-quantized weight (inverse scale folded back)."""
    s = result.scales
    return quantize_fn(w * s[:, None]) / s[:, None]
