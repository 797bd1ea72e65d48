"""RaZeR packed-weight GEMM on Hopper: the wrappers of ``csrc/razer_matmul.cu``
-- K1, which replaces the Pallas ``razer_matmul_pallas``, and its K-shard
form K7 (``razer_matmul_kshard_pallas``) -- and its plain version.

``razer_matmul_cuda`` and ``razer_matmul_kshard_cuda`` take CUDA tensors
only; ``kernels.ops`` sends CPU tensors to ``plain`` instead.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build
from .ref import razer_matmul_ref as plain

__all__ = ["razer_matmul_cuda", "razer_matmul_kshard_cuda", "plain", "BK", "BN", "MAX_SPLITS", "LaunchPlan",
           "launch_plan"]

BK = 64  # K step of the kernel; K must be a multiple of it
BN = 128  # columns of N per block: the CUDA tile's BN (razer_matmul_tile.cuh), which this copy must equal
MAX_SPLITS = 8  # K splits = blocks of one thread-block cluster: the portable cluster size
TOKEN_TILES = (8, 16, 24, 32, 48, 64, 96, 128)  # the instruction widths n the kernel is built for
GRID_Z = 65535  # CUDA's limit on gridDim.z (E x splits) and gridDim.y (token tiles)
# blocks the split-K grid aims for at decode-sized M: two per SM of an H100
# SXM (132 SMs).  A constant, not the card's SM count, so that the split
# boundaries -- and with them every output bit -- depend on (N, K) alone.
_TARGET_BLOCKS = 2 * 132
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
_KSHARD_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]


class LaunchPlan(NamedTuple):
    """The geometry of one K1/K6/K7/K8 launch.  ``bn``, ``splits``,
    ``k_tiles_per_split`` and ``cluster`` come from (N, K) alone; only the
    token tile ``nt`` and the grid's y and z follow M and E, and they do not
    change which K steps an output sums or in what order.  The split sum
    runs through the cluster's distributed shared memory, so a launch needs
    no workspace."""

    nt: int  # tokens per block: the wgmma instruction's n
    bn: int  # columns of N per block
    splits: int  # K splits per output tile
    k_tiles_per_split: int  # BK-deep steps per split (the last may have fewer)
    cluster: int  # blocks per thread-block cluster: a tile's splits (1: no cluster)
    grid: Tuple[int, int, int]  # (column tiles, token tiles, E x splits)


def launch_plan(e: int, m: int, n: int, k: int) -> LaunchPlan:
    """Launch geometry of a packed GEMM of E experts, x (E, M, K) @ (E, K, N).

    K is split until N's column tiles fill about ``_TARGET_BLOCKS`` blocks, at
    most ``MAX_SPLITS`` ways (a split's blocks form one cluster), with no
    empty split.  The row count M never enters the split, so one activation
    row sums its K in the same grouping whatever the batch (decode, padded
    serve slots, a verify pass, prefill), and its output is bit for bit the
    same; the token tile is the smallest instruction width that holds M (128
    tokens per block beyond that)."""
    if k < BK or k % BK or n < 1 or m < 1 or e < 1:
        raise ValueError(f"no packed GEMM launch for E {e}, M {m}, N {n}, K {k} (K a positive multiple of {BK})")
    k_tiles = k // BK
    want = min(max(1, -(-_TARGET_BLOCKS // -(-n // BN))), k_tiles, MAX_SPLITS)
    per = -(-k_tiles // want)
    splits = -(-k_tiles // per)
    nt = next((t for t in TOKEN_TILES if m <= t), TOKEN_TILES[-1])
    grid = (-(-n // BN), -(-m // nt), e * splits)
    if grid[1] > GRID_Z or grid[2] > GRID_Z:
        raise ValueError(f"{e} experts x {splits} K splits, {grid[1]} token tiles: past the grid's limit of {GRID_Z}")
    return LaunchPlan(nt, BN, splits, per, splits if splits > 1 else 1, grid)


def _check(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, what: str, k_shards: int = 1):
    """Validate a K1/K7 call; returns (M, K, N)."""
    if not (x.is_cuda and codes.is_cuda and scale_meta.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors; kernels.ops routes CPU tensors to the plain version")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bf16/f32 tensor, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if codes.dtype != torch.uint8 or scale_meta.dtype != torch.uint8:
        raise ValueError("codes and scale_meta must be uint8")
    n = codes.shape[1]
    if k % BK and k_shards > 1:
        raise ValueError(f"{what}: the local K of this rank's shard is {k} (K {k * k_shards} over tp "
                         f"{k_shards}), and the kernel steps K by {BK}: it needs local K % {BK} == 0")
    if k % BK or codes.shape != (k // 2, n) or scale_meta.shape != (k // 16, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, codes {tuple(codes.shape)}, scale_meta "
                         f"{tuple(scale_meta.shape)} do not form a packed (K, N) GEMM with K % {BK} == 0")
    if not (codes.is_contiguous() and scale_meta.is_contiguous()):
        raise ValueError("codes and scale_meta must be contiguous")
    return m, k, n


def razer_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                      m0: float, m1: float) -> torch.Tensor:
    """x (M, K) bf16 or f32 @ the packed (K, N) weight -> (M, N) f32, without
    the tensor scale."""
    m, k, n = _check(x, codes, scale_meta, "razer_matmul_cuda")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    plan = launch_plan(1, m, n, k)
    fn = build.function("razer_matmul", "razer_matmul_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale_meta.data_ptr(),
                    out.data_ptr(), m, k, n, plan.nt, plan.splits, plan.k_tiles_per_split, float(m0), float(m1),
                    torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_matmul")
    razer_matmul_cuda.launches += 1
    return out


razer_matmul_cuda.launches = 0


def razer_matmul_kshard_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                             m0: float, m1: float, out_chunks: int) -> torch.Tensor:
    """K7: x (M, K_local) @ this rank's packed (K_local, N) shard -> its
    full-N f32 partial, without the tensor scale, laid out for the
    reduce-scatter as (out_chunks, M, N/out_chunks): chunk r holds columns
    [r N/c, (r+1) N/c).  The split count is K1's on the local shape, so the
    result is K1's on the same shard, permuted, bit for bit."""
    m, k, n = _check(x, codes, scale_meta, "razer_matmul_kshard_cuda", out_chunks)
    if out_chunks <= 0 or n % out_chunks:
        raise ValueError(f"N {n} does not split into {out_chunks} output chunks")
    out = torch.empty((out_chunks, m, n // out_chunks), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    plan = launch_plan(1, m, n, k)
    fn = build.function("razer_matmul", "razer_matmul_kshard_launch", _KSHARD_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale_meta.data_ptr(),
                    out.data_ptr(), m, k, n, plan.nt, plan.splits, plan.k_tiles_per_split, out_chunks, float(m0),
                    float(m1), torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_matmul_kshard")
    razer_matmul_kshard_cuda.launches += 1
    return out


razer_matmul_kshard_cuda.launches = 0
