"""Special-value calibration (paper §4.2, Fig. 3, Table 12, App. B.2),
PyTorch port of ``repro.core.calibration``.

Weights: an offline sweep of candidate SV pairs; the paper finds the error
parabolic in |v| with its minimum at +-5, and picks a model-dependent second
pair on top of +-5.  Activations: the single +- pair is chosen on a
calibration set, whatever activation samples the caller collected.

Everything runs on the input's device; each error is a float32 sum, as the
reference's, read back to the host as a Python float.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import torch

from .nvfp4 import nvfp4_qdq
from .razer import razer_qdq, sv_pairs_to_set

__all__ = ["DEFAULT_SV_MAGNITUDES", "sv_pair_sweep", "select_weight_sv_pairs", "calibrate_activation_sv"]

# §4.2: SVs are multiples of 0.5, and the decoder holds their magnitude to
# 6.0 + [-3.5, 3.5] = [2.5, 9.5]; 3, 4 and 6 are on the FP4 grid already.
DEFAULT_SV_MAGNITUDES: Tuple[float, ...] = tuple(m / 2.0 for m in range(5, 20) if m / 2.0 not in (3.0, 4.0, 6.0))


def _err(x: torch.Tensor, xhat: torch.Tensor) -> float:
    d = x - xhat
    return float((d * d).sum())


def sv_pair_sweep(w: torch.Tensor, magnitudes: Sequence[float] = DEFAULT_SV_MAGNITUDES,
                  base_pairs: Sequence[float] = (), block_size: int = 16,
                  scale_fmt: str = "e3m3") -> Dict[float, float]:
    """Fig. 3: the quantization error of adding one SV pair, normalized by
    NVFP4's: {magnitude: error / nvfp4 error}.  ``base_pairs`` stacks the
    sweep on pairs already chosen (the second-pair search)."""
    w = w.to(torch.float32)
    base_err = _err(w, nvfp4_qdq(w, block_size=block_size, scale_fmt=scale_fmt))
    out = {}
    for m in magnitudes:
        xhat = razer_qdq(w, special_values=sv_pairs_to_set(*base_pairs, m), block_size=block_size,
                         scale_fmt=scale_fmt)
        out[float(m)] = _err(w, xhat) / max(base_err, 1e-30)
    return out


def select_weight_sv_pairs(w: torch.Tensor, magnitudes: Sequence[float] = DEFAULT_SV_MAGNITUDES,
                           block_size: int = 16) -> Tuple[float, float]:
    """App. B.2: the best pair, then the best second pair on top of it."""
    first = sv_pair_sweep(w, magnitudes, block_size=block_size)
    m0 = min(first, key=first.get)
    second = sv_pair_sweep(w, [m for m in magnitudes if m != m0], base_pairs=(m0,), block_size=block_size)
    return (m0, min(second, key=second.get))


def calibrate_activation_sv(act_samples: Iterable[torch.Tensor], magnitudes: Sequence[float] = DEFAULT_SV_MAGNITUDES,
                            block_size: int = 16) -> float:
    """The single activation SV pair that minimizes the calibration set's
    error (§4.2), E4M3 block scales."""
    totals: Dict[float, float] = {float(m): 0.0 for m in magnitudes}
    for x in act_samples:
        x = x.to(torch.float32)
        for m in magnitudes:
            xhat = razer_qdq(x, special_values=sv_pairs_to_set(m), block_size=block_size, scale_fmt="e4m3")
            totals[float(m)] += _err(x, xhat)
    return min(totals, key=totals.get)
