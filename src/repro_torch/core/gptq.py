"""GPTQ (Frantar et al. 2023): second-order error-compensating PTQ, the 4-16
baseline of the paper's Tables 3 and 5; PyTorch port of ``repro.core.gptq``.

The column-sequential formulation with the Cholesky-factored inverse Hessian
(no activation reordering), in torch float64 on an explicit device.  Group
quantization follows AutoGPTQ's static groups: when the loop enters a group
of ``group_size`` input channels it freezes the group's weights as they
stand, error compensation included, and each row of the group is then
re-quantized against them with itself substituted.  The group quantizer is
pluggable, so GPTQ composes with INT4 / NVFP4 / RaZeR.

The row loop holds no host synchronization: every value it reads stays on
the device.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import resolve_device

__all__ = ["gptq_quantize", "make_group_quantizer"]


def make_group_quantizer(quantize_group: Callable) -> Callable:
    """Adapt a blocked quantizer into GPTQ's frozen-group row interface.

    ``quantize_group``: a (group_size, d_out) float32 tensor ->
    BlockQuantized-like with ``.dequantize()``.  The returned factory takes
    the group's frozen weights and yields ``quantize_row(i, row)``, the
    dequantized row i of the group quantized with ``row`` in place of its
    row i."""

    def factory(w_group: torch.Tensor):
        frozen = w_group.to(torch.float32)

        def quantize_row(i: int, row: torch.Tensor) -> torch.Tensor:
            g = frozen.clone()
            g[i, :] = row
            return quantize_group(g).dequantize()[i, :]

        return quantize_row

    return factory


def gptq_quantize(w, calib_x, group_quantizer_factory: Callable, *, group_size: int = 16,
                  block_size: int = 128, damp: float = 0.01, device="cuda") -> torch.Tensor:
    """Quantize W (d_in, d_out) with GPTQ error compensation -> the
    dequantized float32 weight on ``device``.

    ``w`` and ``calib_x`` are tensors or numpy arrays; ``calib_x``: (n,
    d_in) calibration activations, H = X^T X;
    ``group_quantizer_factory(w_group) -> fn(row_idx, row) -> dequantized
    row`` (``make_group_quantizer``)."""
    dev = resolve_device(device)
    w = torch.as_tensor(w, device=dev).to(torch.float64).clone()  # updated in place below
    d_in = w.shape[0]
    x = torch.as_tensor(calib_x, device=dev).to(torch.float64).reshape(-1, d_in)
    if not (block_size % group_size == 0 or group_size % block_size == 0):
        raise ValueError(f"block_size {block_size} and group_size {group_size}: one must divide the other")

    h = x.T @ x
    h += torch.eye(d_in, dtype=torch.float64, device=dev) * damp * torch.mean(torch.diagonal(h) + 1e-8)
    dead = torch.diagonal(h) == 0
    torch.diagonal(h).masked_fill_(dead, 1.0)  # the diagonal entries only, as numpy's h[dead, dead]
    w.masked_fill_(dead[:, None], 0.0)

    hinv = torch.linalg.inv(h)
    hinv_chol = torch.linalg.cholesky(hinv).T  # upper triangular

    q = torch.zeros_like(w)
    row_quant = None
    for b0 in range(0, d_in, block_size):
        b1 = min(b0 + block_size, d_in)
        w_blk = w[b0:b1, :].clone()
        err_blk = torch.zeros_like(w_blk)
        for i in range(b1 - b0):
            gi = b0 + i
            if gi % group_size == 0:
                # the group's weights with all error compensation applied so
                # far; a group may reach past this block into later rows
                g1 = min(gi + group_size, d_in)
                grp = w_blk[i:min(i + group_size, b1 - b0), :]
                if g1 > b1:
                    grp = torch.cat([grp, w[b1:g1, :]], dim=0)
                row_quant = group_quantizer_factory(grp.to(torch.float32))
            q_i = row_quant(gi % group_size, w_blk[i, :].to(torch.float32)).to(torch.float64)
            q[gi, :] = q_i
            e = (w_blk[i, :] - q_i) / hinv_chol[gi, gi]
            w_blk[i + 1:, :] -= torch.outer(hinv_chol[gi, b0 + i + 1:b1], e)
            err_blk[i, :] = e
        if b1 < d_in:
            w[b1:, :] -= hinv_chol[b0:b1, b1:].T @ err_blk
    return q.to(torch.float32)
