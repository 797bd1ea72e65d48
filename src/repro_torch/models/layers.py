"""Shared layers of the dense decoder (PyTorch port of ``repro.models.layers``).

Conventions kept from the JAX package: parameters are float32 master copies
cast to the compute dtype in the forward; weights are (d_in, d_out); every
linear goes through ``qlinear`` so a QuantPolicy packs or fake-quantizes it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.core.qlinear import is_kshard, qlinear


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device, dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/d_in) weights, drawn on ``device`` from ``gen``."""
    w = torch.randn((d_in, d_out), generator=gen, device=device, dtype=dtype)
    return w.mul_(1.0 / math.sqrt(d_in))


def swiglu_init(gen: torch.Generator, d: int, f: int, *, device, dtype=torch.float32):
    return {"gate": dense_init(gen, d, f, device=device, dtype=dtype),
            "up": dense_init(gen, d, f, device=device, dtype=dtype),
            "down": dense_init(gen, f, d, device=device, dtype=dtype)}


def embedding_init(gen: torch.Generator, vocab: int, d_model: int, *, device, dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=gen, device=device, dtype=dtype).mul_(0.02)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``(1 + gamma)`` gain convention, computed in f32: on
    the card the row-invariant kernel (K10), on the CPU the plain version
    (``kernels.ref.rms_norm_ref``)."""
    from repro_torch.kernels import ops

    return ops.rms_norm(x, gamma, eps)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S): rotary embedding on split halves
    (not interleaved pairs)."""
    hd = x.shape[-1]
    ang = positions[..., None].to(torch.float32) * rope_freqs(hd, theta, x.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, p, quant: QuantPolicy = BF16) -> torch.Tensor:
    """SwiGLU MLP.  When all three weights are K/tp shards on a serving mesh
    the chain stays sharded: gate and up leave their f/tp columns, which
    silu * mul keeps and which are exactly down's K slice, and only down's
    d output is gathered."""
    chain = all(is_kshard(p[r]) for r in ("gate", "up", "down"))
    g = qlinear(x, p["gate"], quant, gather=not chain)
    h = g * torch.sigmoid(g) * qlinear(x, p["up"], quant, gather=not chain)
    return qlinear(h, p["down"], quant, sharded_in=chain)


def embed(tokens: torch.Tensor, table: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    return table[tokens].to(compute_dtype)  # gather first: the same values, without casting the whole table


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """LM head: x @ table.T, the (vocab, d) table cast to x's dtype."""
    return x @ table.to(x.dtype).T
