"""App. D.3: two-pass realization of RaZeR W4A4 on NVFP4-only hardware,
PyTorch port of ``repro.core.twopass``.

Hardware with a native NVFP4 GEMM but no remap datapath can still run RaZeR
exactly by splitting the weight into two NVFP4-legal matrices:

    D = A @ B_main + A @ B_comp

B_main replaces each remapped -0 with a signed base value; B_comp holds the
correcting offset at those slots (zero elsewhere).  Both hold only FP4 values
under the same block scales.  The paper's example for {+-5, +-8}:
+-5 = +-4 + +-1 and +-8 = +-4 + +-4.  Any special value that is the sum of
two FP4 values splits; §D.3 lists the reachable set {+-2.5, ..., +-12}.

The two passes are plain matmuls, as in the reference (outside any kernel).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .formats import FP4_POS_VALUES
from .nvfp4 import BlockQuantized, block_unreshape
from .razer import razer_quantize

__all__ = ["split_special_value", "two_pass_weights", "two_pass_matmul"]

_POS = [float(v) for v in FP4_POS_VALUES]


def split_special_value(v: float) -> Tuple[float, float]:
    """s -> (x1, x2), both FP4-representable, x1 + x2 == s (§D.3)."""
    sign = -1.0 if v < 0 else 1.0
    mag = abs(v)
    # the paper's canonical base is +-4; other grid values for magnitudes
    # 4 cannot reach
    for x1 in [4.0] + sorted((p for p in _POS if p != 4.0), reverse=True):
        x2 = mag - x1
        if x2 in _POS or -x2 in _POS:
            return sign * x1, sign * x2
    raise ValueError(f"special value {v} not expressible as a 2-term FP4 sum")


def two_pass_weights(bq: BlockQuantized) -> Tuple[torch.Tensor, torch.Tensor]:
    """RaZeR-quantized weight -> (W_main, W_comp), dense dequantized halves.

    W_main + W_comp == bq.dequantize() exactly; W_comp is nonzero only at
    remapped slots (its density is Fig. 7's sparse bound)."""
    sv = bq.sv[..., None]
    is_sv = (bq.sv_index[..., None] >= 0) & (bq.q == sv) & (sv != 0)
    main_map = torch.zeros_like(bq.q)
    comp_map = torch.zeros_like(bq.q)
    for v in torch.unique(bq.sv).tolist():
        if v != 0:
            x1, x2 = split_special_value(float(v))
            hit = is_sv & (sv == v)
            main_map = torch.where(hit, x1, main_map)
            comp_map = torch.where(hit, x2, comp_map)
    q_main = torch.where(is_sv, main_map, bq.q)
    q_comp = torch.where(is_sv, comp_map, torch.zeros_like(bq.q))
    scale = (bq.block_scale * bq.tensor_scale)[..., None]
    return block_unreshape(q_main * scale, bq.axis), block_unreshape(q_comp * scale, bq.axis)


def two_pass_matmul(x: torch.Tensor, w: torch.Tensor, **razer_kw):
    """Exact RaZeR W4 GEMM as two NVFP4-legal passes -> (y, comp_density),
    the density the fraction of nonzero B_comp entries (Fig. 7's bound)."""
    bq = razer_quantize(w, axis=0, **razer_kw)
    w_main, w_comp = two_pass_weights(bq)
    y = x @ w_main + x @ w_comp  # two accumulating GEMM passes
    return y, (w_comp != 0).to(torch.float32).mean()
