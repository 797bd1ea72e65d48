"""RaZeR dynamic activation fake-quant on Hopper: the wrapper of
``csrc/razer_quantize.cu`` (which replaces the Pallas ``razer_act_qdq_pallas``)
and its plain version.

The kernel receives one float32 table (``table_numpy``): the E4M3 scale grid,
the FP4 grid and, per special value, the two midpoints around it, built here
from the same numpy grids the plain version rounds onto, so both search the
same midpoints.  The packed GEMM's fused x path (K1, K7 at decode-sized M)
takes the same table.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.formats import grid_midpoints, positive_format_values
from repro_torch.core.razer import FP4_GRID, grid_with_sv

from . import build
from .ref import razer_act_qdq_ref as plain

__all__ = ["razer_act_qdq_cuda", "plain", "act_table", "table_numpy"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _I, _L, _P, _I, _P]
_MAX_SVS = 4
# offsets of csrc/razer_act_qdq.cuh's table, which this layout must equal
_SCALE_VALS, _SCALE_MIDS, _BASE_VALS, _BASE_MIDS = 0, 128, 256, 272
_SV_VALS, _SV_LO, _SV_HI, _TABLE = 288, 292, 296, 304


def table_numpy(svs: tuple) -> np.ndarray:
    """The float32 table the kernels round with: the positive E4M3 grid and
    its midpoints (+inf past the last), the FP4 grid and its midpoints, and
    for each special value v the midpoints of the FP4 grid with v added
    just below and above v (-inf / +inf where v is the smallest / largest):
    that grid rounds s to v exactly where lo < s <= hi, and like the FP4
    grid elsewhere.  All midpoints are the float32 ones the plain version
    searches."""
    if len(svs) > _MAX_SVS:
        raise ValueError(f"the kernel tries at most {_MAX_SVS} special values, got {len(svs)}")
    t = np.zeros(_TABLE, np.float32)
    scale = positive_format_values("e4m3")
    t[_SCALE_VALS:_SCALE_VALS + len(scale)] = scale
    t[_SCALE_MIDS:_BASE_VALS] = np.inf
    t[_SCALE_MIDS:_SCALE_MIDS + len(scale) - 1] = grid_midpoints(scale)
    t[_BASE_VALS:_BASE_VALS + len(FP4_GRID)] = FP4_GRID
    t[_BASE_MIDS:_SV_VALS] = np.inf
    t[_BASE_MIDS:_BASE_MIDS + len(FP4_GRID) - 1] = grid_midpoints(FP4_GRID)
    for i, v in enumerate(svs):
        g = grid_with_sv(v)
        mids = grid_midpoints(g)
        j = int(np.flatnonzero(g == np.float32(v))[0])
        t[_SV_VALS + i] = v
        t[_SV_LO + i] = mids[j - 1] if j > 0 else -np.inf
        t[_SV_HI + i] = mids[j] if j < len(mids) else np.inf
    return t


@functools.lru_cache(maxsize=None)
def act_table(device: str, svs: tuple) -> torch.Tensor:
    """``table_numpy(svs)`` on ``device``, copied there once."""
    return torch.from_numpy(table_numpy(svs)).to(device)


def razer_act_qdq_cuda(x: torch.Tensor, svs=(5.0, -5.0)) -> torch.Tensor:
    """Fake-quantize the 16-element blocks of the last dim of a contiguous
    bf16/f32 CUDA tensor; same shape and dtype out."""
    if not x.is_cuda:
        raise ValueError("razer_act_qdq_cuda takes CUDA tensors; kernels.ops.razer_act_qdq "
                         "routes CPU tensors to the plain version")
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16/f32 tensor, got {x.dtype}")
    if x.shape[-1] % 16:
        raise ValueError(f"last dim {x.shape[-1]} is not a multiple of the 16-element block")
    svs = tuple(float(v) for v in svs)
    table = act_table(str(x.device), svs)
    y = torch.empty_like(x)
    fn = build.function("razer_quantize", "razer_act_qdq_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(), table.data_ptr(),
                    len(svs), torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_act_qdq")
    razer_act_qdq_cuda.launches += 1
    return y


razer_act_qdq_cuda.launches = 0
