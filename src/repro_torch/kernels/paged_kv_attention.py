"""Decode and speculative-verify attention over the paged RaZeR-packed KV
pool on Hopper: the wrappers of ``csrc/paged_kv_attention.cu`` (K4, which
replaces the Pallas ``paged_kv_attention_pallas``, and K5, which replaces
``paged_kv_attention_verify_pallas``) and their plain versions."""
from __future__ import annotations

import ctypes

import torch

from . import attention_plan, build
from .ref import paged_kv_attention_ref as plain
from .ref import paged_kv_attention_verify_ref as plain_verify

__all__ = ["paged_kv_attention_cuda", "paged_kv_attention_verify_cuda", "plain", "plain_verify"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 6 + [_P]  # K4: ..., out, ws, counters, B, NP, ps, KVH, G, hd, stream
_VERIFY_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]  # K5: ..., B, T, first query, queries, NP, ps, KVH, G, hd, stream


def _check(name, q, pool, page_table, cur_len, check_pages: bool):
    """Validate what both kernels take; return (B, NP, ps, KVH, G, hd)."""
    tensors = (q, *pool, page_table, cur_len)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors; kernels.ops routes CPU tensors to the plain version")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if q.dtype != torch.float32:
        raise ValueError(f"q must be float32, got {q.dtype}")
    k_codes = pool[0]
    if k_codes.dim() != 4:
        raise ValueError(f"pool arrays must be (P, ps, KVH, x), got {tuple(k_codes.shape)}")
    n_pages, ps, kvh, _ = k_codes.shape
    h, hd = q.shape[-2:]
    if h % kvh or not 1 <= h // kvh <= attention_plan.MAX_G or hd not in attention_plan.HEAD_DIMS:
        raise ValueError(f"unsupported heads H={h}, KVH={kvh}, hd={hd} (G = H/KVH <= 8, hd in {attention_plan.HEAD_DIMS})")
    for t, width in zip(pool, (hd // 2, hd // 16, hd // 2, hd // 16)):
        if t.dtype != torch.uint8 or tuple(t.shape) != (n_pages, ps, kvh, width):
            raise ValueError(f"pool tensor {t.dtype} {tuple(t.shape)} != uint8 {(n_pages, ps, kvh, width)}")
    b = q.shape[0]
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be (B, NP) int32, got {page_table.dtype} {tuple(page_table.shape)}")
    if cur_len.dtype != torch.int32 or tuple(cur_len.shape) != (b,):
        raise ValueError(f"cur_len must be (B,) int32, got {cur_len.dtype} {tuple(cur_len.shape)}")
    if check_pages:  # a device sync: for tests and debugging, not the serving loop
        lo, hi = int(page_table.min()), int(page_table.max())
        if lo < 0 or hi >= n_pages:
            raise ValueError(f"page_table entries [{lo}, {hi}] fall outside the pool's {n_pages} pages")
    return b, page_table.shape[1], ps, kvh, h // kvh, hd


def paged_kv_attention_cuda(q, k_codes, k_meta, v_codes, v_meta, page_table, cur_len, *,
                            check_pages: bool = False) -> torch.Tensor:
    """K4: q (B, H, hd) f32 against the pool (P, ps, KVH, hd/2 | hd/16) uint8
    through page_table (B, NP) int32 over cur_len (B,) int32 positions, all
    CUDA and contiguous -> (B, H, hd) f32.  ``check_pages`` bounds-checks
    the table on the host first."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, hd), got {tuple(q.shape)}")
    pool = (k_codes, k_meta, v_codes, v_meta)
    b, n_p, ps, kvh, g, hd = _check("paged_kv_attention_cuda", q, pool, page_table, cur_len, check_pages)
    out = torch.empty_like(q)
    ws, tickets = attention_plan.workspace(q.device, *attention_plan.workspace_size(b, kvh, n_p * ps, g, hd))
    fn = build.function("paged_kv_attention", "paged_kv_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), *(t.data_ptr() for t in pool), page_table.data_ptr(), cur_len.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), b, n_p, ps, kvh, g, hd,
                    torch.cuda.current_stream().cuda_stream)
    build.check(status, "paged_kv_attention")
    paged_kv_attention_cuda.launches += 1
    return out


def paged_kv_attention_verify_cuda(q, k_codes, k_meta, v_codes, v_meta, page_table, cur_len, *,
                                   check_pages: bool = False) -> torch.Tensor:
    """K5: q (B, T, H, hd) f32; query t of sequence b attends positions
    < cur_len[b] + t + 1 (cur_len = the committed length) -> (B, T, H, hd)
    f32.  One block reads a split's pages once for up to 32 // G queries;
    a larger T launches the kernel once per 32 // G queries, each masked at
    its own length, so every query returns K4's bits there.  Pool and table
    as ``paged_kv_attention_cuda``."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd), got {tuple(q.shape)}")
    pool = (k_codes, k_meta, v_codes, v_meta)
    b, n_p, ps, kvh, g, hd = _check("paged_kv_attention_verify_cuda", q, pool, page_table, cur_len,
                                    check_pages)
    t = q.shape[1]
    step = min(t, attention_plan.MAX_ROWS // g)  # queries a launch takes
    out = torch.empty_like(q)
    ws, tickets = attention_plan.workspace(q.device, *attention_plan.workspace_size(b, kvh, n_p * ps, step * g, hd))
    fn = build.function("paged_kv_attention", "paged_kv_attention_verify_launch", _VERIFY_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for t0 in range(0, t, step):
            status = fn(q.data_ptr(), *(x.data_ptr() for x in pool), page_table.data_ptr(), cur_len.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), b, t, t0, min(step, t - t0), n_p, ps,
                        kvh, g, hd, stream)
            build.check(status, "paged_kv_attention_verify")
            paged_kv_attention_verify_cuda.launches += 1
    return out


paged_kv_attention_cuda.launches = 0
paged_kv_attention_verify_cuda.launches = 0
