"""RaZeR dynamic activation fake-quant on Hopper: the wrapper of
``csrc/razer_quantize.cu`` (which replaces the Pallas ``razer_act_qdq_pallas``)
and its plain version.

The kernel receives the E4M3 scale grid and the candidate grids (FP4, then
FP4 with each special value) with their float32 midpoints, built here from
the same numpy grids the plain version rounds onto, so both search the same
midpoints.
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

__all__ = ["razer_act_qdq_cuda", "plain"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _I, _L, _P, _P, _I, _P, _P, _I, _P]
_MAX_SVS = 4


@functools.lru_cache(maxsize=None)
def _tables(device: str, svs: tuple):
    """(scale_vals, scale_mids, cand_vals, cand_mids) float32 on ``device``."""
    scale = positive_format_values("e4m3")
    grids = [FP4_GRID] + [grid_with_sv(v) for v in svs]
    vals = np.zeros((len(grids), 16), np.float32)
    mids = np.full((len(grids), 16), np.inf, np.float32)
    for i, g in enumerate(grids):
        vals[i, : len(g)] = g
        mids[i, : len(g) - 1] = grid_midpoints(g)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return to(scale), to(grid_midpoints(scale)), to(vals), to(mids)


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
    if len(svs) > _MAX_SVS:
        raise ValueError(f"the kernel tries at most {_MAX_SVS} special values, got {len(svs)}")
    scale_vals, scale_mids, cand_vals, cand_mids = _tables(str(x.device), svs)
    y = torch.empty_like(x)
    fn = build.function("razer_quantize", "razer_act_qdq_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(),
                    scale_vals.data_ptr(), scale_mids.data_ptr(), scale_vals.numel(),
                    cand_vals.data_ptr(), cand_mids.data_ptr(), cand_vals.shape[0],
                    torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_act_qdq")
    razer_act_qdq_cuda.launches += 1
    return y


razer_act_qdq_cuda.launches = 0
