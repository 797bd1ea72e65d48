"""Low-precision value grids used by NVFP4 / RaZeR (PyTorch port).

Mirrors ``repro.core.formats``: the FP4-E2M1 element grid with its code
layout, the ExMy block-scale grids (OCP E4M3 drops 480), nearest-value
rounding with ties toward the lower grid value, and FP4 code <-> value
conversion.  The grids are numpy constants; rounding runs on tensors of any
device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "FP4_VALUES",
    "FP4_POS_VALUES",
    "FP4_MAX",
    "FP4_NEG_ZERO_CODE",
    "positive_format_values",
    "round_to_values",
    "fp4_encode",
    "fp4_decode",
    "device_constant",
]

# FP4-E2M1 (Eq. 5).  code = s<<3 | e<<1 | m, so FP4_VALUES[code] is the value.
FP4_POS_VALUES = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)
FP4_VALUES = np.concatenate([FP4_POS_VALUES, -FP4_POS_VALUES])  # code order 0..15
FP4_MAX = 6.0
FP4_NEG_ZERO_CODE = 8  # s=1, e=0, m=0 -- the redundant code RaZeR remaps.


def _exmy_positive_values(n_exp: int, n_man: int, ocp_e4m3: bool = False) -> np.ndarray:
    """All non-negative values of an ExMy minifloat (bias 2^(x-1)-1,
    subnormals at E=0).  OCP E4M3 reserves its top encoding for NaN, so its
    grid stops at 448 instead of 480."""
    bias = 2 ** (n_exp - 1) - 1
    vals = [0.0]
    n_mant_vals = 2**n_man
    for e in range(2**n_exp):
        for m in range(n_mant_vals):
            if e == 0:
                v = 2.0 ** (1 - bias) * (m / n_mant_vals)
            else:
                v = 2.0 ** (e - bias) * (1.0 + m / n_mant_vals)
            vals.append(v)
    out = np.unique(np.array(vals, np.float64)).astype(np.float32)
    if ocp_e4m3:
        out = out[:-1]
    return out


@functools.lru_cache(maxsize=None)
def positive_format_values(fmt: str) -> np.ndarray:
    """Sorted non-negative value grid for a format name like 'e4m3'."""
    fmt = fmt.lower()
    if fmt in ("fp4", "e2m1"):
        return FP4_POS_VALUES
    if not (fmt.startswith("e") and "m" in fmt):
        raise ValueError(f"unknown format {fmt!r}")
    n_exp = int(fmt[1 : fmt.index("m")])
    n_man = int(fmt[fmt.index("m") + 1 :])
    return _exmy_positive_values(n_exp, n_man, ocp_e4m3=(fmt == "e4m3"))


def grid_midpoints(values: np.ndarray) -> np.ndarray:
    """float32 midpoints of a sorted grid, computed as the JAX package does."""
    values = np.asarray(values, np.float32)
    return (values[1:] + values[:-1]) / np.float32(2.0)


def device_constant(a: np.ndarray, device) -> torch.Tensor:
    """A small numpy table as a tensor on ``device``, copied there once.

    A host-to-device copy waits for the work queued before it, so copying a
    grid on every call would stall the decode loop; callers must not write
    to the returned tensor."""
    a = np.ascontiguousarray(a)
    return _device_constant(a.tobytes(), a.dtype.str, a.shape, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _device_constant(data: bytes, dtype: str, shape: tuple, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=dtype).reshape(shape).copy()).to(device)


def round_to_values(x: torch.Tensor, values: np.ndarray) -> torch.Tensor:
    """Round each element of float32 ``x`` to the nearest entry of a sorted grid.

    ``searchsorted(mids, x, right=False)``: a value exactly on a midpoint
    goes to the lower grid value."""
    values = np.asarray(values, np.float32)
    mids = device_constant(grid_midpoints(values), x.device)
    idx = torch.searchsorted(mids, x.contiguous(), right=False)
    return device_constant(values, x.device)[idx]


def fp4_encode(x: torch.Tensor) -> torch.Tensor:
    """Values on the FP4 grid (or any reals: nearest) -> uint8 codes.

    The redundant -0 code (8) is never produced: zeros encode as +0."""
    mids = device_constant(grid_midpoints(FP4_POS_VALUES), x.device)
    mag_code = torch.searchsorted(mids, x.abs().contiguous(), right=False).to(torch.uint8)
    sign = (x < 0) & (mag_code > 0)
    return torch.where(sign, mag_code + 8, mag_code)


def fp4_decode(codes: torch.Tensor, special_value=None) -> torch.Tensor:
    """uint8 codes -> float32 values; code 8 decodes to ``special_value``
    (the RaZeR remap) when one is given."""
    vals = device_constant(FP4_VALUES, codes.device)[codes.long()]
    if special_value is not None:
        vals = torch.where(codes == FP4_NEG_ZERO_CODE, special_value, vals)
    return vals
