"""State-space blocks (PyTorch port of ``repro.models.ssm``): Mamba-2's SSD
mixer (chunked) and RecurrentGemma's RG-LRU.

Each has a full-sequence path (the prefill: SSD by the chunked
state-space-duality algorithm, RG-LRU by an associative scan) and a
one-token decode step that carries a recurrent state.  The projections go
through ``qlinear``, so a policy packs them like any linear; the recurrent
states stay float32, as in the JAX package.  The scans are plain PyTorch
ops: no TPU kernel stands behind them in the reference either.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.core.qlinear import qlinear

from .config import ArchConfig
from .layers import dense_init, rms_norm

__all__ = ["mamba2_dims", "mamba2_init", "mamba2_forward", "mamba2_prefill", "mamba2_state_init", "mamba2_decode",
           "rglru_init", "rglru_forward", "rglru_prefill", "rglru_state_init", "rglru_decode", "rglru_scan"]


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------
def mamba2_dims(cfg: ArchConfig) -> Tuple[int, int]:
    """(d_inner, number of SSD heads)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, *, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d_inner, nheads = mamba2_dims(cfg)
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * d_inner + 2 * n + nheads, device=device, dtype=dtype),  # z x B C dt
        "conv_w": torch.randn((cfg.conv_kernel, conv_dim), generator=gen, device=device, dtype=dtype).mul_(0.1),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, device=device)).to(dtype),
        "D": torch.ones(nheads, dtype=dtype, device=device),
        "dt_bias": torch.zeros(nheads, dtype=dtype, device=device),
        "norm": torch.zeros(d_inner, dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, device=device, dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along the sequence: x (B, S, C), w (K, C),
    tap i weighting position t - (K - 1) + i, summed in tap order."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last K - 1 inputs of a prefill (all of a shorter one, as the
    reference's slice gives): the decode step's conv state."""
    return x[:, max(0, x.shape[1] - (k - 1)):]


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One step of the causal convolution: x_t (B, C) after ``conv_state``
    (B, K - 1, C), the last K - 1 inputs -> (out (B, C), the new state).

    A prefill of fewer than K - 1 tokens leaves a shorter state; the
    reference's step then fails on the shapes (an einsum of K - 1 rows
    against K taps), and so does this one, with the cause."""
    k = w.shape[0]
    if conv_state.shape[1] != k - 1:
        raise ValueError(f"the causal conv's decode state holds {conv_state.shape[1]} inputs, not conv_kernel - 1 = "
                         f"{k - 1}: the prompt had fewer than {k - 1} tokens, and the reference's decode step "
                         f"(models/ssm.py::_conv_step) fails on it too; prompts need >= {k - 1} tokens to decode")
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, C)
    return (full * w).sum(dim=1) + b, full[:, 1:]


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    d_inner, _ = mamba2_dims(cfg)
    n = cfg.ssm_state
    return zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * n], zxbcdt[..., 2 * d_inner + 2 * n:]


def _ssd_chunked(xh: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 chunk: int):
    """Chunked SSD (Mamba-2 §6), in float32: xh (B, S, H, P), bmat and cmat
    (B, S, N), dt (B, S, H), a_log (H,) -> (y (B, S, H, P), the final state
    (B, H, P, N)).  The chunk is ``min(chunk, S)``, halved until it divides
    S, as the reference picks it; inside a chunk the decay matrix is masked
    in the exponent; the chunk states run through a sequential scan."""
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    a = -torch.exp(a_log.float())  # (H,), negative
    dt = dt.float()
    da = dt * a  # (B, S, H): log decay a step

    xw = (xh.float() * dt[..., None]).reshape(bsz, nc, q, h, p)
    bm = bmat.float().reshape(bsz, nc, q, n)
    cm = cmat.float().reshape(bsz, nc, q, n)
    cs = torch.cumsum(da.reshape(bsz, nc, q, h), dim=2)  # in-chunk cumulative log decay

    # in-chunk: L[i, j] = exp(cs_i - cs_j) for i >= j, masked in the exponent
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B, nc, q, q, H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    li = torch.where(tri[None, None, :, :, None], li, torch.full_like(li, -math.inf))
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * torch.exp(li), xw)

    # chunk summaries: S_c = sum_j exp(cs_last - cs_j) B_j (x) xw_j
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # (B, nc, q, H)
    s_chunk = torch.einsum("bcjn,bcjhp->bchpn", bm, xw * decay_to_end[..., None])

    # the recurrence over chunk states: h_before[c] is the state entering chunk c
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B, nc, H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_before = torch.stack(before, dim=1)  # (B, nc, H, P, N)

    # across chunks: y_i += exp(cs_i) C_i . h_before
    y_inter = torch.einsum("bcin,bchpn->bcihp", cm, h_before) * torch.exp(cs)[..., None]
    return (y_intra + y_inter).reshape(bsz, s, h, p), state


def mamba2_prefill(x: torch.Tensor, p, cfg: ArchConfig, quant: QuantPolicy):
    """The full-sequence Mamba-2 block -> (output, {"h", "conv"} decode
    state) (the reference's ``transformer._mamba_prefill``)."""
    bsz, s, _ = x.shape
    d_inner, nheads = mamba2_dims(cfg)
    n = cfg.ssm_state
    z, xbc, dt = _split_proj(qlinear(x, p["in_proj"], quant), cfg)
    conv_tail = _conv_tail(xbc, cfg.conv_kernel)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)))
    xi = xbc[..., :d_inner].reshape(bsz, s, nheads, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    y, final = _ssd_chunked(xi, xbc[..., d_inner:d_inner + n], xbc[..., d_inner + n:], dt, p["A_log"], cfg.ssm_chunk)
    y = y + xi.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(x.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return qlinear(y, p["out_proj"], quant), {"h": final, "conv": conv_tail.to(x.dtype)}


def mamba2_forward(x: torch.Tensor, p, cfg: ArchConfig, *, quant: QuantPolicy = BF16) -> torch.Tensor:
    """Full-sequence Mamba-2 block, x (B, S, d_model)."""
    return mamba2_prefill(x, p, cfg, quant)[0]


def mamba2_state_init(cfg: ArchConfig, batch: int, *, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d_inner, nheads = mamba2_dims(cfg)
    return {"h": torch.zeros((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_inner + 2 * cfg.ssm_state), dtype=dtype,
                                device=device)}


def mamba2_decode(x: torch.Tensor, p, cfg: ArchConfig, state, *, quant: QuantPolicy = BF16):
    """One token, x (B, 1, d_model) -> (y (B, 1, d_model), the new state)."""
    bsz = x.shape[0]
    d_inner, nheads = mamba2_dims(cfg)
    n = cfg.ssm_state
    z, xbc, dt = _split_proj(qlinear(x[:, 0, :], p["in_proj"], quant), cfg)
    xbc, conv_state = _conv_step(xbc, state["conv"], p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xbc = F.silu(xbc)
    xi = xbc[..., :d_inner].reshape(bsz, nheads, cfg.ssm_head_dim).float()
    bmat = xbc[..., d_inner:d_inner + n].float()
    cmat = xbc[..., d_inner + n:].float()
    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B, H)
    da = torch.exp(dt * -torch.exp(p["A_log"].float()))
    upd = (xi * dt[:, :, None])[..., None] * bmat[:, None, None, :]  # (B, H, P, N)
    h = state["h"] * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h, cmat)
    y = y + xi * p["D"].float()[None, :, None]
    y = y.reshape(bsz, d_inner).to(x.dtype) * F.silu(z)
    y = qlinear(rms_norm(y, p["norm"], cfg.norm_eps), p["out_proj"], quant)
    return y[:, None, :], {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma's recurrent block)
# ---------------------------------------------------------------------------
_RGLRU_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ArchConfig, *, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width or cfg.d_model
    lin = lambda i, o: dense_init(gen, i, o, device=device, dtype=dtype)  # noqa: E731
    return {
        "w_in": lin(cfg.d_model, w),  # the x branch
        "w_gate": lin(cfg.d_model, w),  # the GELU gate branch
        "conv_w": torch.randn((cfg.conv_kernel, w), generator=gen, device=device, dtype=dtype).mul_(0.1),
        "conv_b": torch.zeros(w, dtype=dtype, device=device),
        "wa": lin(w, w),  # the recurrence gate r_t
        "wx": lin(w, w),  # the input gate i_t
        "a_param": torch.full((w,), 2.0, dtype=dtype, device=device),  # a = sigmoid(2.0) ~ 0.88
        "out_proj": lin(w, cfg.d_model),
    }


def _rglru_gates(xb: torch.Tensor, p, quant: QuantPolicy):
    """(a_t, b_t) of h_t = a_t h_{t-1} + b_t, in float32."""
    r = torch.sigmoid(qlinear(xb, p["wa"], quant).float())
    i = torch.sigmoid(qlinear(xb, p["wx"], quant).float())
    log_at = _RGLRU_C * r * F.logsigmoid(p["a_param"].float())
    at = torch.exp(log_at)
    beta = torch.sqrt(torch.clamp(1.0 - at ** 2, min=1e-12))
    return at, beta * (i * xb.float())


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1,
    by the recursion ``jax.lax.associative_scan`` runs: combine adjacent
    pairs, scan the pairs, then fill the even positions from the odd ones;
    about 2 log2(S) levels of elementwise ops, the products grouped as the
    reference groups them.  -> (the decays' products, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = rglru_scan(ra, rb)  # positions 1, 3, 5, ...
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], dim=1), torch.cat([b[:, :1], eb], dim=1)  # positions 0, 2, 4, ...
    out = []
    for even, odd in ((ea, oa), (eb, ob)):
        t = torch.empty_like(a)
        t[:, 0::2] = even
        t[:, 1::2] = odd
        out.append(t)
    return out[0], out[1]


def rglru_prefill(x: torch.Tensor, p, cfg: ArchConfig, quant: QuantPolicy):
    """The full-sequence recurrent block -> (output, {"h", "conv"} decode
    state) (the reference's ``transformer._rglru_prefill``)."""
    gate = F.gelu(qlinear(x, p["w_gate"], quant), approximate="tanh")  # jax.nn.gelu's default
    xb = qlinear(x, p["w_in"], quant)
    conv_tail = _conv_tail(xb, cfg.conv_kernel)
    xb = _causal_conv(xb, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    _, h = rglru_scan(*_rglru_gates(xb, p, quant))
    y = qlinear(h.to(x.dtype) * gate, p["out_proj"], quant)
    return y, {"h": h[:, -1, :], "conv": conv_tail.to(x.dtype)}


def rglru_forward(x: torch.Tensor, p, cfg: ArchConfig, *, quant: QuantPolicy = BF16) -> torch.Tensor:
    """Full-sequence Griffin recurrent block, x (B, S, d_model)."""
    return rglru_prefill(x, p, cfg, quant)[0]


def rglru_state_init(cfg: ArchConfig, batch: int, *, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, w), dtype=dtype, device=device)}


def rglru_decode(x: torch.Tensor, p, cfg: ArchConfig, state, *, quant: QuantPolicy = BF16):
    """One token, x (B, 1, d_model) -> (y (B, 1, d_model), the new state)."""
    xt = x[:, 0, :]
    gate = F.gelu(qlinear(xt, p["w_gate"], quant), approximate="tanh")
    xb, conv_state = _conv_step(qlinear(xt, p["w_in"], quant), state["conv"], p["conv_w"].to(x.dtype),
                                p["conv_b"].to(x.dtype))
    at, bt = _rglru_gates(xb, p, quant)
    h = at * state["h"] + bt
    y = qlinear(h.to(x.dtype) * gate, p["out_proj"], quant)
    return y[:, None, :], {"h": h, "conv": conv_state}
