"""Collectives of the serving mesh over ``torch.distributed`` (PyTorch port of
``repro.parallel.collectives``, plus the exchanges the reference leaves to
XLA's partitioner).

  * ``reduce_scatter`` -- the K-shard epilogue's exchange: this rank's
    partials, already laid out chunk-major by the kernel's epilogue, summed
    over the tp group into this rank's N/tp tile;
  * ``all_gather_last`` / ``all_gather_first`` -- rebuild a full width or a
    full expert/group dim from the ranks' tiles;
  * ``dispatch_to_expert_shards`` / ``combine_from_expert_shards`` -- the
    tiled all-to-alls of expert-parallel MoE;
  * ``wire_encode`` / ``wire_decode`` / ``quantized_all_gather`` -- an
    all-gather whose payload travels in the RaZeR 4.5-bit wire format;
  * the train mesh's, with autograd: ``gather_dim`` -- an all-gather along
    a dim whose backward reduce-scatters the gradient (an FSDP weight
    shard, the sequence-parallel gather of the residual rows);
    ``scatter_dim`` -- its mirror (row-parallel partial sums summed and
    scattered to the sequence rows; backward an all-gather); ``group_sum``
    -- an all-reduce whose backward is the identity (the loss's sums over
    the batch and sequence shards); ``all_reduce_`` -- in place, no
    autograd (gradients of replicated leaves).  Sums of bf16 / f16 run in
    f32 and round once.  A group of None (one rank) passes its input
    through untouched.

gloo takes CPU tensors only for most of these: on a gloo group a CUDA tensor
is copied to the host, exchanged and copied back (two ranks sharing one card
can only run over gloo).  NCCL takes the CUDA tensors as they are.  The
backend is the mesh's, chosen by the caller.  ``stats`` counts the calls
and the host seconds spent in them, staging included.
"""
from __future__ import annotations

import time
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import expert_shard_size

__all__ = ["reduce_scatter", "all_gather_last", "all_gather_first", "dispatch_to_expert_shards",
           "combine_from_expert_shards", "wire_encode", "wire_decode", "quantized_all_gather", "gather_dim",
           "scatter_dim", "group_sum", "all_reduce_", "stats"]

stats = {"calls": 0, "seconds": 0.0}


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend takes it: a host copy of a CUDA tensor
    on a gloo group, else ``t`` itself (contiguous)."""
    t = t.contiguous()
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def _timed(fn):
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            stats["calls"] += 1
            stats["seconds"] += time.perf_counter() - t0
    run.__doc__, run.__name__ = fn.__doc__, fn.__name__
    return run


@_timed
def reduce_scatter(chunks: torch.Tensor, group) -> torch.Tensor:
    """chunks (n, *tile): this rank's partial of every rank's tile, rank r's
    at ``chunks[r]`` -> the sum over the group of the tiles at this rank's
    index (the reference's ``psum_scatter(..., tiled=True)`` once the
    partials are laid out chunk-major)."""
    n = dist.get_world_size(group)
    if chunks.shape[0] != n:
        raise ValueError(f"reduce_scatter wants {n} chunks (one per rank), got {tuple(chunks.shape)}")
    src = _staged(chunks, group)
    out = torch.empty(chunks.shape[1:], dtype=chunks.dtype, device=src.device)
    dist.reduce_scatter_tensor(out.view(-1), src.view(-1), group=group)  # flat: gloo splits dim 0
    return out.to(chunks.device)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's x, in rank order."""
    n = dist.get_world_size(group)
    src = _staged(x, group)
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=src.device)
    dist.all_gather_into_tensor(out.view(-1), src.view(-1), group=group)
    return out.to(x.device)


@_timed
def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """(..., w) tiles -> (..., n w), rank r's tile at columns [r w, (r+1) w)."""
    g = _gather(x, group)
    return g.movedim(0, -2).reshape(*x.shape[:-1], -1)


@_timed
def all_gather_first(x: torch.Tensor, group) -> torch.Tensor:
    """(a, ...) tiles -> (n a, ...), rank r's tile at rows [r a, (r+1) a)."""
    return _gather(x, group).reshape(-1, *x.shape[1:])


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...): block r goes to rank r; returns (n, ...) with block s
    from rank s."""
    src = _staged(x, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out.view(-1), src.view(-1), group=group)
    return out.to(x.device)


@_timed
def dispatch_to_expert_shards(buf: torch.Tensor, group) -> torch.Tensor:
    """Token-sharded -> expert-sharded MoE dispatch: this rank's groups
    ``(g_local, E, cap, d)`` -> every group's slots for this rank's experts
    ``(g, E/ep, cap, d)`` (the reference's tiled all-to-all, split on the
    expert dim, concatenated on the group dim).  Raises the
    ``expert_shard_size`` error when ep does not divide E."""
    ep = dist.get_world_size(group)
    gl, e = buf.shape[:2]
    le = expert_shard_size(e, ep)
    blocks = buf.reshape(gl, ep, le, *buf.shape[2:]).movedim(1, 0)  # block r: rank r's experts
    return _all_to_all(blocks, group).reshape(ep * gl, le, *buf.shape[2:])


@_timed
def combine_from_expert_shards(h: torch.Tensor, group) -> torch.Tensor:
    """Expert-sharded -> token-sharded MoE combine, the inverse of
    ``dispatch_to_expert_shards``: ``(g, E/ep, cap, d)`` -> this rank's
    groups with every expert's slots, ``(g/ep, E, cap, d)``."""
    ep = dist.get_world_size(group)
    g, le = h.shape[:2]
    got = _all_to_all(h.reshape(ep, g // ep, le, *h.shape[2:]), group)  # block s: rank s's experts
    return got.movedim(0, 1).reshape(g // ep, ep * le, *h.shape[2:])


def wire_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Flatten to rows of the last dim (a multiple of 16) and pack them in
    the RaZeR KV wire format -> (codes u8, meta u8, original shape)."""
    from repro_torch.serving.kvcache import kv_quantize

    shape = tuple(x.shape)
    codes, meta = kv_quantize(x.reshape(-1, shape[-1]))
    return codes, meta, shape


def wire_decode(codes: torch.Tensor, meta: torch.Tensor, shape, dtype=torch.bfloat16) -> torch.Tensor:
    from repro_torch.serving.kvcache import kv_dequantize

    return kv_dequantize(codes, meta, shape[-1]).reshape(shape).to(dtype)


@_timed
def quantized_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather along dim 0 whose payload is the 4.5-bit wire format: a
    bf16 shard of S bytes moves 0.28125 S.  The result is the
    quantize-dequantized gather, in x's dtype."""
    codes, meta, shape = wire_encode(x)
    n = dist.get_world_size(group)
    g_codes = _gather(codes, group).reshape(-1, codes.shape[-1])
    g_meta = _gather(meta, group).reshape(-1, meta.shape[-1])
    return wire_decode(g_codes, g_meta, (shape[0] * n,) + shape[1:], dtype=x.dtype)


# ---------------------------------------------------------------------------
# the train mesh's collectives (autograd)
# ---------------------------------------------------------------------------
def _sum_dtype(dtype):
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    g = all_gather_first(x.movedim(dim, 0).contiguous(), group)
    return g.movedim(0, dim)


def _scatter_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"cannot scatter dim {dim} of {tuple(x.shape)} over {n} ranks")
    chunks = x.to(_sum_dtype(x.dtype)).movedim(dim, 0)
    chunks = chunks.reshape(n, x.shape[dim] // n, *chunks.shape[1:])
    return reduce_scatter(chunks, group).movedim(0, dim).to(x.dtype)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_along(grad, ctx.dim, ctx.group), None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_along(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_along(grad, ctx.dim, ctx.group), None, None


@_timed
def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group (a new tensor, in t's dtype)."""
    src = _staged(t.to(_sum_dtype(t.dtype)), group)
    if src is t:
        src = src.clone()
    dist.all_reduce(src, group=group)
    return src.to(device=t.device, dtype=t.dtype)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of ``dim``, concatenated in rank order; the
    gradient of the result is summed over the group and this rank's block
    returned (a reduce-scatter)."""
    return x if group is None else _GatherDim.apply(x, dim, group)


def scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of every rank's ``x``, this rank's block of
    ``dim`` kept (a reduce-scatter); the backward all-gathers the gradient."""
    return x if group is None else _ScatterDim.apply(x, dim, group)


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of every rank's ``x``.  The gradient passes
    through unchanged: each rank differentiates its own share of a value
    every rank holds, and the parameters' gradients are summed later."""
    return x if group is None else _GroupSum.apply(x, group)


@torch.no_grad()
def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place."""
    if group is not None:
        t.copy_(_all_reduce(t, group))
    return t
