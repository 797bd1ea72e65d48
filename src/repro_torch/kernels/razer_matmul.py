"""RaZeR packed-weight GEMM on Hopper: the wrappers of ``csrc/razer_matmul.cu``
-- K1, which replaces the Pallas ``razer_matmul_pallas``, and its K-shard
form K7 (``razer_matmul_kshard_pallas``) -- and its plain version.

``razer_matmul_cuda`` and ``razer_matmul_kshard_cuda`` take CUDA tensors
only; ``kernels.ops`` sends CPU tensors to ``plain`` instead.  Under W4A4
they take the activation's special values (``act_svs``) and return the bits
of the activation fake-quant (K2) followed by the GEMM: at decode-sized M
(``launch_plan(...).fuse_act``) the GEMM fake-quantizes x in its own x load,
one launch; at larger M, K2 runs first and the GEMM reads its output.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from .razer_quantize import act_table, razer_act_qdq_cuda
from .ref import razer_matmul_ref as plain

__all__ = ["razer_matmul_cuda", "razer_matmul_kshard_cuda", "plain", "BK", "BN", "MAX_SPLITS", "LaunchPlan",
           "launch_plan", "FUSE_ACT_MAX_M"]

BK = 64  # K step of the kernel; K must be a multiple of it
BN = 128  # columns of N per block: the CUDA tile's BN (razer_matmul_tile.cuh), which this copy must equal
MAX_SPLITS = 8  # K splits = blocks of one thread-block cluster: the portable cluster size
TOKEN_TILES = (8, 16, 24, 32, 48, 64, 96, 128)  # the instruction widths n the kernel is built for
GRID_Z = 65535  # CUDA's limit on gridDim.z (E x splits) and gridDim.y (token tiles)
# blocks the split-K grid aims for at decode-sized M: two per SM of an H100
# SXM (132 SMs).  A constant, not the card's SM count, so that the split
# boundaries -- and with them every output bit -- depend on (N, K) alone.
_TARGET_BLOCKS = 2 * 132
# the largest M at which a W4A4 K1/K7 fake-quantizes x in its own load
# instead of after a K2 launch.  Every column block (N / 128 of them, 8 to
# 64 for llama3_2_3b) quantizes its x rows again, so the fused launch takes
# more device time than K2 + K1 at every M (+0.027 ms a llama layer at M =
# 4, x8 at M = 128; tools/fused_act_timing.py, PERF.md), but it saves K2's
# launch and host call, and the decode step is bound by the host: a layer's
# calls end sooner fused up to M = 16 and later from M = 24 on.  A token
# tile's edge, so decode (4 slots) and speculate_k=2 verify (12 rows) fuse
# and prefill buckets do not.  Both paths give the same bits.
FUSE_ACT_MAX_M = 16
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _I, _P]
_KSHARD_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _I, _P]


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
    fuse_act: bool  # under W4A4 (K1, K7): fake-quantize x in the GEMM's load, not in a K2 launch first


def launch_plan(e: int, m: int, n: int, k: int) -> LaunchPlan:
    """Launch geometry of a packed GEMM of E experts, x (E, M, K) @ (E, K, N).

    K is split until N's column tiles fill about ``_TARGET_BLOCKS`` blocks, at
    most ``MAX_SPLITS`` ways (a split's blocks form one cluster), with no
    empty split.  The row count M never enters the split, so one activation
    row sums its K in the same grouping whatever the batch (decode, padded
    serve slots, a verify pass, prefill), and its output is bit for bit the
    same; the token tile is the smallest instruction width that holds M (128
    tokens per block beyond that).  ``fuse_act`` follows M alone (M <=
    ``FUSE_ACT_MAX_M``); the fused and the two-launch W4A4 paths give the
    same bits."""
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
    return LaunchPlan(nt, BN, splits, per, splits if splits > 1 else 1, grid, m <= FUSE_ACT_MAX_M)


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


def _act(x: torch.Tensor, plan: LaunchPlan, act_svs, fused: Optional[bool]):
    """(x for the GEMM, act table pointer, special-value count) of a call:
    without ``act_svs`` x as it is; fused, x with the table; else K2's
    output.  ``fused`` overrides the plan's choice (the checks that hold
    the two paths against each other)."""
    if act_svs is None:
        return x, None, 0
    svs = tuple(float(v) for v in act_svs)
    if plan.fuse_act if fused is None else fused:
        return x, act_table(str(x.device), svs).data_ptr(), len(svs)
    return razer_act_qdq_cuda(x, svs), None, 0


def _count(fn, table) -> None:
    fn.launches += 1
    if table is not None:
        fn.fused_act_launches += 1


def razer_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                      m0: float, m1: float, act_svs=None, fused: Optional[bool] = None) -> torch.Tensor:
    """x (M, K) bf16 or f32 @ the packed (K, N) weight -> (M, N) f32, without
    the tensor scale.  ``act_svs``: fake-quantize x first (W4A4), fused
    into the GEMM's x load at decode-sized M, else by a K2 launch."""
    m, k, n = _check(x, codes, scale_meta, "razer_matmul_cuda")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    plan = launch_plan(1, m, n, k)
    x, table, nsv = _act(x, plan, act_svs, fused)
    fn = build.function("razer_matmul", "razer_matmul_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale_meta.data_ptr(),
                    out.data_ptr(), m, k, n, plan.nt, plan.splits, plan.k_tiles_per_split, float(m0), float(m1),
                    table, nsv, torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_matmul")
    _count(razer_matmul_cuda, table)
    return out


razer_matmul_cuda.launches = 0  # every K1 launch
razer_matmul_cuda.fused_act_launches = 0  # those that fake-quantized x in their load


def razer_matmul_kshard_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                             m0: float, m1: float, out_chunks: int, act_svs=None,
                             fused: Optional[bool] = None) -> torch.Tensor:
    """K7: x (M, K_local) @ this rank's packed (K_local, N) shard -> its
    full-N f32 partial, without the tensor scale, laid out for the
    reduce-scatter as (out_chunks, M, N/out_chunks): chunk r holds columns
    [r N/c, (r+1) N/c).  The split count is K1's on the local shape, so the
    result is K1's on the same shard, permuted, bit for bit.  ``act_svs``
    as K1's: the local K slice holds whole 16-value blocks."""
    m, k, n = _check(x, codes, scale_meta, "razer_matmul_kshard_cuda", out_chunks)
    if out_chunks <= 0 or n % out_chunks:
        raise ValueError(f"N {n} does not split into {out_chunks} output chunks")
    out = torch.empty((out_chunks, m, n // out_chunks), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    plan = launch_plan(1, m, n, k)
    x, table, nsv = _act(x, plan, act_svs, fused)
    fn = build.function("razer_matmul", "razer_matmul_kshard_launch", _KSHARD_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale_meta.data_ptr(),
                    out.data_ptr(), m, k, n, plan.nt, plan.splits, plan.k_tiles_per_split, out_chunks, float(m0),
                    float(m1), table, nsv, torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_matmul_kshard")
    _count(razer_matmul_kshard_cuda, table)
    return out


razer_matmul_kshard_cuda.launches = 0  # every K7 launch
razer_matmul_kshard_cuda.fused_act_launches = 0  # those that fake-quantized x in their load
