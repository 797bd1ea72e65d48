"""Low-precision value grids used by NVFP4 / RaZeR (PyTorch port).

Mirrors ``repro.core.formats``: the FP4-E2M1 element grid with its code
layout, the ExMy block-scale grids (OCP E4M3 drops 480), nearest-value
rounding with ties toward the lower grid value, and FP4 code <-> value
conversion.  The grids are numpy constants; rounding runs on tensors of any
device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "FP4_VALUES",
    "FP4_POS_VALUES",
    "FP4_MAX",
    "FP4_NEG_ZERO_CODE",
    "float_format_values",
    "positive_format_values",
    "round_to_values",
    "round_to_format",
    "ValueSet",
    "fp4_encode",
    "fp4_decode",
    "device_constant",
    "floor_log2",
    "ceil_log2",
    "exp2_int",
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


@functools.lru_cache(maxsize=None)
def float_format_values(fmt: str) -> np.ndarray:
    """Sorted signed value grid for a format name."""
    pos = positive_format_values(fmt)
    return np.unique(np.concatenate([pos, -pos])).astype(np.float32)


@dataclass(frozen=True)
class ValueSet:
    """A finite quantization grid with nearest-value rounding."""

    values: tuple  # sorted floats

    @staticmethod
    def from_format(fmt: str, signed: bool = True) -> "ValueSet":
        v = float_format_values(fmt) if signed else positive_format_values(fmt)
        return ValueSet(tuple(float(x) for x in v))

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return round_to_values(x, np.array(self.values, np.float32))

    @property
    def max(self) -> float:
        return float(self.values[-1])


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


def round_to_format(x: torch.Tensor, fmt: str, signed: bool = True) -> torch.Tensor:
    """Round float32 ``x`` onto a format's signed (or non-negative) grid."""
    return round_to_values(x, float_format_values(fmt) if signed else positive_format_values(fmt))


# ---------------------------------------------------------------------------
# The reference's float32 log2 and exp2 at the points its formats read them.
# XLA computes jnp.log2(x) as f32(log(x)) * f32(1 / ln 2) (the division by the
# constant ln 2 becomes that product) and jnp.exp2(e) as exp(f32(ln 2) * e),
# with results below the smallest normal float32 flushed to zero.  So
# floor(log2(x)) steps from k - 1 to k up to 123 ulps away from 2^k, and
# exp2 of an integer is tens of ulps off the power of two for most.  The
# steps are tables read off the JAX package on the CPU (every one checked by
# ``tests/test_torch_baselines.py``), so the card and the CPU agree with the
# reference for every input.
# ---------------------------------------------------------------------------
_F32_TINY = float(np.finfo(np.float32).tiny)  # smallest normal float32

# Where floor(log2(x)) steps to k, for k = -124 .. 127: the float32 2^k moved
# by this many ulps.
_FLOOR_LOG2_FIRST = -124
_FLOOR_LOG2_STEP_ULPS = (
    -35, -59, -83, -107, -3, -27, -51, -75, -99, -123, -19, -43, -67, -91, -115, -11, -35, -59, -83,
    -107, -3, -27, -51, -75, -99, -123, -19, -43, -67, -91, -115, -10, -66, -26, -50, -74, -34, -58,
    -82, -42, -66, -26, -50, -74, -34, -58, -82, -42, -66, -26, -50, -74, -34, -58, -82, -42, -66,
    -26, -50, -74, -34, -58, -17, -41, -1, -25, -49, -9, -33, -57, -17, -41, -1, -25, -49, -9, -33,
    -57, -33, -25, -17, -41, -33, -25, -17, -41, -33, -25, -17, -41, -33, -25, -17, -8, 0, -24, -16,
    -8, 0, -24, -16, -16, -8, -16, -8, -16, -8, -16, -8, 0, -8, 0, -8, -4, -4, -4, -4, -4, -4, -2,
    -2, -2, -1, 0, 0, 0, 0, -1, -1, -1, -3, -3, -3, -3, -3, -3, -7, 1, -7, 1, -7, -15, -7, -15, -7,
    -15, -7, -15, -15, -7, 1, 5, -15, -7, 1, 5, -14, -6, -30, -22, -14, -6, -30, -22, -14, -6, -30,
    -22, -14, -6, -30, -6, -30, 5, -14, -38, 1, -22, 9, -6, -30, 5, -14, -38, 1, -22, 9, -5, -29,
    -53, -13, -37, -61, -21, -45, -5, -29, -53, -13, -37, -61, -21, -45, -5, -29, -53, -13, -37,
    -61, -21, -45, -5, -29, -53, -13, -37, -61, 6, -13, -36, -60, -84, 10, -4, -28, -52, -76, 14, 2,
    -20, -44, -68, 18, 6, -12, -36, -60, -84, 10, -4, -28, -52, -76, 14, 2, -20, -44, -68, 18, 6,
    -11, -35
)
# Where ceil(log2(x)) steps to k + 1, for k = 0 .. 127: likewise.
_CEIL_LOG2_STEP_ULPS = (
    1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 5, 1, 5, 1, 5, 9, 5, 9, 5, 9, 5, 9, 9, 13, 1, 5, 9, 13, 1,
    5, 9, 13, 17, 21, 9, 13, 17, 21, 9, 13, 17, 21, 9, 13, 17, 29, 17, 5, 25, 13, 1, 21, 9, 29, 17,
    5, 25, 13, 1, 21, 9, 30, 18, 38, 26, 14, 34, 22, 42, 30, 18, 38, 26, 14, 34, 22, 42, 30, 18, 38,
    26, 14, 34, 22, 42, 30, 18, 38, 26, 14, 34, 6, 58, 46, 34, 22, 10, 62, 50, 38, 26, 14, 2, 54,
    42, 30, 18, 6, 58, 46, 34, 22, 10, 62, 50, 38, 26, 14, 2, 54, 42, 30, 18, 6, 59, 47
)


def _steps(first: int, ulps) -> np.ndarray:
    k = np.arange(first, first + len(ulps))
    bits = np.ldexp(np.float32(1.0), k).astype(np.float32).view(np.int32) + np.array(ulps, np.int32)
    return bits.astype(np.int32).view(np.float32)


def _exp2_table() -> np.ndarray:
    """float32 ``exp(f32(ln 2) * e)`` for e = -127 .. 127, flushed to zero
    below the smallest normal float32."""
    e = np.arange(-127, 128).astype(np.float32)
    v = np.exp((np.float32(np.log(2.0)) * e).astype(np.float64)).astype(np.float32)
    return np.where(v < _F32_TINY, np.float32(0.0), v).astype(np.float32)


_FLOOR_LOG2_STEPS = _steps(_FLOOR_LOG2_FIRST, _FLOOR_LOG2_STEP_ULPS)
_CEIL_LOG2_STEPS = _steps(0, _CEIL_LOG2_STEP_ULPS)
_EXP2 = _exp2_table()


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``floor(log2(x))`` of positive float32 ``x`` as int64;
    below 2^-124 (subnormals included) it is -125 or less in the reference,
    and -125 here."""
    steps = device_constant(_FLOOR_LOG2_STEPS, x.device)
    return torch.searchsorted(steps, x.contiguous(), right=True) + (_FLOOR_LOG2_FIRST - 1)


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``max(ceil(log2(x)), 0)`` of positive float32 ``x``
    as int64."""
    return torch.searchsorted(device_constant(_CEIL_LOG2_STEPS, x.device), x.contiguous(), right=True)


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """The reference's float32 ``exp2(e)`` of integer ``e`` in [-127, 127]."""
    return device_constant(_EXP2, e.device)[e.long() + 127]


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
