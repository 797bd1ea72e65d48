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
    all-gather whose payload travels in the RaZeR 4.5-bit wire format.

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
           "combine_from_expert_shards", "wire_encode", "wire_decode", "quantized_all_gather", "stats"]

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
