"""Dispatch layer over the port's kernels (counterpart of
``repro.kernels.ops``).

A CUDA tensor goes to the hand-written kernel and a CPU tensor to its plain
version; for a CUDA tensor nothing falls back, so a failed build or launch
raises.  The wrappers here also flatten leading batch dims and, for the
matmul, apply the tensor scale in the epilogue and cast back to x's dtype.
Rows past M in the matmul's last tile are masked inside the kernel, which
stands in for the JAX wrapper's M padding.

The K-shard matmuls (``razer_matmul_kshard``, ``razer_grouped_matmul_kshard``)
run on one rank's K/tp shard and end in ``reduce_scatter_epilogue``: each
rank's full-N partial, tensor scale applied and cast to x's dtype as the
reference does before its exchange, is summed over the tp group into this
rank's N/tp tile.

Gradients: on the CPU autograd runs through the plain versions.  On the
card, where a kernel's output has no autograd history, ``prefill_attention``
and ``rms_norm`` go through ``torch.autograd.Function``s whose backward is a
kernel too (K9's and K10's backward) when a gradient is asked for;
``razer_act_qdq`` (K2) has no backward and refuses an input that wants a
gradient (QAT passes it a detached x, ``qlinear.qdq_activation``); the
packed GEMMs serve inference only.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PackedRazerWeight, PackedStackedTensor

from . import ref
from .paged_kv_attention import paged_kv_attention_cuda, paged_kv_attention_verify_cuda
from .prefill_attention import prefill_attention_cuda
from .prefill_attention_bwd import check_args as _check_attention_bwd
from .prefill_attention_bwd import prefill_attention_bwd_cuda
from .rms_norm import rms_norm_cuda
from .rms_norm_bwd import rms_norm_bwd_cuda
from .razer_grouped_matmul import razer_grouped_matmul_cuda, razer_grouped_matmul_kshard_cuda
from .razer_kv_attention import razer_kv_attention_cuda
from .razer_matmul import razer_matmul_cuda, razer_matmul_kshard_cuda
from .razer_quantize import razer_act_qdq_cuda

__all__ = ["razer_matmul", "razer_grouped_matmul", "reduce_scatter_epilogue", "razer_matmul_kshard",
           "razer_grouped_matmul_kshard", "razer_act_qdq", "razer_kv_attention", "razer_paged_kv_attention",
           "razer_paged_kv_attention_verify", "prefill_attention", "rms_norm"]


def _card_block(block: int) -> None:
    """The activation kernels (K2, K1/K7's fused x load) quantize 16-value
    blocks."""
    if block != 16:
        raise ValueError(f"the activation kernels quantize 16-element blocks, not {block}")


def razer_matmul(x: torch.Tensor, pw: PackedRazerWeight, *, act_svs=None, act_block: int = 16) -> torch.Tensor:
    """y = x @ dequant(pw) for x (..., K) -> (..., N) in x's dtype.

    ``act_svs``: under W4A4, the activation's special values; x is
    fake-quantized first (``act_block``-element blocks, E4M3 scales): on
    the card by K1 in its own x load at decode-sized M, else by K2 before
    K1 (the same bits); on the CPU by the plain version before the plain
    matmul."""
    k, n = pw.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match packed weight {pw.shape}")
    lead = x.shape[:-1]
    xf = x.reshape(-1, k)
    if x.is_cuda:
        if act_svs is not None:
            _card_block(act_block)
        y = razer_matmul_cuda(xf.contiguous(), pw.codes, pw.scale_meta,
                              m0=pw.sv_magnitudes[0], m1=pw.sv_magnitudes[1], act_svs=act_svs)
        y = y * pw.tensor_scale
    else:
        if act_svs is not None:
            xf = ref.razer_act_qdq_ref(xf, svs=act_svs, block=act_block)
        y = ref.razer_matmul_ref(xf, pw)  # the tensor scale is inside the f32 weight
    return y.reshape(*lead, n).to(x.dtype)


def razer_grouped_matmul(x: torch.Tensor, pst: PackedStackedTensor) -> torch.Tensor:
    """y[e] = x[e] @ dequant(pst[e]) for x (E, M, K) -> (E, M, N) in x's
    dtype; on the card the per-expert tensor scale is applied here."""
    e, k, n = pst.shape
    if x.dim() != 3 or x.shape[0] != e or x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match packed bank {pst.shape}")
    if x.is_cuda:
        y = razer_grouped_matmul_cuda(x.contiguous(), pst.codes, pst.scale_meta,
                                      m0=pst.sv_magnitudes[0], m1=pst.sv_magnitudes[1])
        y = y * pst.tensor_scale[:, None, None]
    else:
        y = ref.razer_grouped_matmul_ref(x, pst)  # the tensor scales are inside the f32 bank
    return y.to(x.dtype)


def reduce_scatter_epilogue(chunks: torch.Tensor, group) -> torch.Tensor:
    """chunks (tp, ..., N/tp): this rank's partial product laid out
    chunk-major by the K-shard kernel -> the sum over the tp group of chunk
    ``rank`` (the reference's last-dim ``psum_scatter``)."""
    from repro_torch.parallel.collectives import reduce_scatter

    return reduce_scatter(chunks, group)


def _chunked(y: torch.Tensor, c: int) -> torch.Tensor:
    """(..., N) -> (c, ..., N/c), chunk r holding columns [r N/c, (r+1) N/c):
    what the kernels' out_chunks epilogue writes, for the plain version."""
    return y.reshape(*y.shape[:-1], c, y.shape[-1] // c).movedim(-2, 0).contiguous()


def _kshard_group(container, group):
    if group is None:
        raise ValueError(f"a K/{container.k_shards} shard needs its tp group to reduce over")
    return container.k_shards


def razer_matmul_kshard(x: torch.Tensor, pw: PackedRazerWeight, *, group, act_svs=None,
                        act_block: int = 16) -> torch.Tensor:
    """x (..., K/tp) @ this rank's K/tp shard ``pw`` (``pw.k_shards`` = tp),
    the partials summed over ``group`` -> (..., N/tp), this rank's columns,
    in x's dtype.  K7 on the card.  ``act_svs``, ``act_block`` as ``razer_matmul``'s, on
    this rank's K slice (whole 16-element blocks, so the bits of
    quantizing the full x and slicing it)."""
    tp = _kshard_group(pw, group)
    k, n = pw.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match this rank's packed shard {pw.shape}")
    lead = x.shape[:-1]
    xf = x.reshape(-1, k)
    if x.is_cuda:
        if act_svs is not None:
            _card_block(act_block)
        y = razer_matmul_kshard_cuda(xf.contiguous(), pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                     m1=pw.sv_magnitudes[1], out_chunks=tp, act_svs=act_svs)
        y = (y * pw.tensor_scale).to(x.dtype)
    else:
        if act_svs is not None:
            xf = ref.razer_act_qdq_ref(xf, svs=act_svs, block=act_block)
        y = _chunked(ref.razer_matmul_ref(xf, pw).to(x.dtype), tp)
    return reduce_scatter_epilogue(y, group).reshape(*lead, n // tp)


def razer_grouped_matmul_kshard(x: torch.Tensor, pst: PackedStackedTensor, *, group) -> torch.Tensor:
    """x (E_local, M, K/tp) @ this rank's bank tile -> (E_local, M, N/tp),
    the partials summed over ``group``, in x's dtype.  K8 on the card."""
    tp = _kshard_group(pst, group)
    e, k, n = pst.shape
    if x.dim() != 3 or x.shape[0] != e or x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match this rank's bank tile {pst.shape}")
    if x.is_cuda:
        y = razer_grouped_matmul_kshard_cuda(x.contiguous(), pst.codes, pst.scale_meta,
                                             m0=pst.sv_magnitudes[0], m1=pst.sv_magnitudes[1], out_chunks=tp)
        y = (y * pst.tensor_scale[:, None, None]).to(x.dtype)
    else:
        y = _chunked(ref.razer_grouped_matmul_ref(x, pst).to(x.dtype), tp)
    return reduce_scatter_epilogue(y, group)


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def razer_act_qdq(x: torch.Tensor, *, svs=(5.0, -5.0), block: int = 16) -> torch.Tensor:
    """Fused dynamic activation fake-quant over the last dim (any batch
    shape).  On the card the kernel (K2), which has no backward: an x that
    wants a gradient raises, where the reference would differentiate the
    quantizer's own jnp ops (QAT with a straight-through estimator,
    ``ste=True``, passes a detached x)."""
    if x.is_cuda:
        if _wants_grad(x):
            raise ValueError("the activation fake-quant kernel (K2) has no backward: a gradient through it is not "
                             "computed on the card; train with a straight-through estimator "
                             "(QuantPolicy.fakequant(..., ste=True)), or run on the CPU")
        _card_block(block)
        return razer_act_qdq_cuda(x.contiguous(), svs)
    return ref.razer_act_qdq_ref(x, svs=svs, block=block)


def razer_kv_attention(q: torch.Tensor, cache, cur_len) -> torch.Tensor:
    """Decode attention over a packed KV cache dict (serving.kvcache layout).

    q: (B, 1, H, hd) or (B, H, hd); cur_len: int or (B,) valid lengths.
    Returns q's shape and dtype."""
    squeeze = q.dim() == 4
    qf = q[:, 0] if squeeze else q
    caches = (cache["k_codes"], cache["k_meta"], cache["v_codes"], cache["v_meta"])
    if q.is_cuda:
        b = qf.shape[0]
        cl = torch.as_tensor(cur_len, dtype=torch.int32, device=q.device).reshape(-1).expand(b)
        out = razer_kv_attention_cuda(qf.to(torch.float32).contiguous(),
                                      *(c.contiguous() for c in caches), cl.contiguous())
    else:
        out = ref.razer_kv_attention_ref(qf, *caches, cur_len)
    out = out.to(q.dtype)
    return out[:, None] if squeeze else out


def _pool_arrays(cache):
    return cache["k_codes"], cache["k_meta"], cache["v_codes"], cache["v_meta"]


def _lengths(cur_len, b: int, device) -> torch.Tensor:
    return torch.as_tensor(cur_len, dtype=torch.int32, device=device).reshape(-1).expand(b).contiguous()


def razer_paged_kv_attention(q: torch.Tensor, cache, page_table: torch.Tensor, cur_len) -> torch.Tensor:
    """Decode attention over a paged pool slice (serving.pagepool layout:
    arrays (P, ps, KVH, x), page_table (B, NP), cur_len (B,) valid lengths).

    q: (B, 1, H, hd) or (B, H, hd); returns q's shape and dtype."""
    squeeze = q.dim() == 4
    qf = q[:, 0] if squeeze else q
    pool = _pool_arrays(cache)
    if q.is_cuda:
        out = paged_kv_attention_cuda(qf.to(torch.float32).contiguous(), *pool,
                                      page_table.to(torch.int32).contiguous(),
                                      _lengths(cur_len, qf.shape[0], q.device))
    else:
        out = ref.paged_kv_attention_ref(qf, *pool, page_table, cur_len)
    out = out.to(q.dtype)
    return out[:, None] if squeeze else out


def razer_paged_kv_attention_verify(q: torch.Tensor, cache, page_table: torch.Tensor, cur_len) -> torch.Tensor:
    """Multi-query verify attention over a paged pool slice: q (B, T, H, hd),
    query t at position cur_len[b] + t attending positions < cur_len[b] + t
    + 1; ``cur_len`` is the committed length and the T positions' wire bytes
    are already in the pages.  Returns (B, T, H, hd) in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"verify attention wants (B, T, H, hd) queries, got {tuple(q.shape)}")
    pool = _pool_arrays(cache)
    if q.is_cuda:
        out = paged_kv_attention_verify_cuda(q.to(torch.float32).contiguous(), *pool,
                                             page_table.to(torch.int32).contiguous(),
                                             _lengths(cur_len, q.shape[0], q.device))
    else:
        out = ref.paged_kv_attention_verify_ref(q, *pool, page_table, cur_len)
    return out.to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, kv_chunk: int = 1024) -> torch.Tensor:
    """GQA prefill attention, causal or not, with an optional sliding
    ``window``, q (B, Sq, H, hd) against k (B, Skv, KVH, hd) and v (B, Skv,
    KVH, dv) -> (B, Sq, H, dv) in q's dtype (dv = hd, or MLA's narrower V).
    On the card the prefill kernel (K9), whose rows do not depend on the
    batch or the padding, at the widths it is built for (anything else
    raises); ``kv_chunk`` is the plain version's chunk and does not reach
    the kernel."""
    if q.is_cuda:
        if _wants_grad(q, k, v):
            return _PrefillAttention.apply(q, k, v, causal, window, q_offset)
        return prefill_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window,
                                      q_offset=q_offset)
    return ref.chunked_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset, kv_chunk=kv_chunk)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim with the (1 + gamma) gain, in f32, out in
    x's dtype.  On the card the kernel (K10), whose rows do not depend on
    how many rows the call holds."""
    if x.is_cuda:
        if _wants_grad(x, gamma):
            return _RmsNorm.apply(x, gamma, eps)
        return rms_norm_cuda(x, gamma, eps)
    return ref.rms_norm_ref(x, gamma, eps)


class _PrefillAttention(torch.autograd.Function):
    """K9 forward, K9's backward kernel backward, at every width the forward
    takes (MLA's hd 192 with V at 128 and hd 256 among them); the widths
    are checked before the forward runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        _check_attention_bwd(q, k, v)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = prefill_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = prefill_attention_bwd_cuda(q, k, v, out, dout.contiguous(), **ctx.mask)
        return dq, dk, dv, None, None, None


class _RmsNorm(torch.autograd.Function):
    """K10 forward, K10's backward kernel backward."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rms_norm_cuda(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = rms_norm_bwd_cuda(x, gamma, dy.to(x.dtype), ctx.eps)
        return dx, dgamma, None
