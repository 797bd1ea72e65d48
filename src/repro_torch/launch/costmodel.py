"""Analytic cost model and the H100's peak rates (the port's counterpart of
``repro.launch.costmodel``).

``model_flops`` follows the reference: 6 N D for a train step (N the
parameters, D the tokens; an MoE model's active parameters), 2 N D for a
prefill, 2 N B for a decode step.  Attention and the backward's recompute
are not in it, so a train step's ``model_flops`` over its time is the model
FLOP utilization.  Parameter counts come from the port's own parameter tree,
built on the ``meta`` device.

The peaks are the card's (NVIDIA's H100 SXM data sheet, dense, at the full
700 W): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM, NVLink 450
GB/s each way to the other cards of the host.  ``xla_cost_analysis`` of the
reference reads XLA's compiled cost and has no counterpart here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ArchConfig

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "param_counts", "model_flops", "roofline_terms", "dominant"]

PEAK_FLOPS = 989e12  # bf16 FLOP/s, dense tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way, per card


def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """{"total", "expert", "active"} parameter counts of the tree; an MoE
    model's active count takes topk of its n_experts expert banks."""
    from repro_torch.models.transformer import init_params

    total = expert = 0

    def walk(node, in_experts=False):
        nonlocal total, expert
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, in_experts or k == "experts")
        elif isinstance(node, list):
            for v in node:
                walk(v, in_experts)
        else:
            total += node.numel()
            expert += node.numel() if in_experts else 0

    walk(init_params(cfg, device="meta"))
    non_expert = total - expert
    active = non_expert + expert * cfg.topk / cfg.n_experts if cfg.moe and cfg.n_experts else total
    return {"total": float(total), "expert": float(expert), "active": float(active)}


def model_flops(cfg: ArchConfig, seq_len: int, global_batch: int, kind: str) -> float:
    """train 6 N_active D; prefill 2 N_active D; decode 2 N_active B (one
    token a sequence)."""
    n_active = param_counts(cfg)["active"]
    if kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    if kind == "decode":
        return 2.0 * n_active * global_batch
    raise ValueError(kind)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float, coll_bytes_per_dev: float) -> Dict[str, float]:
    """Seconds each resource needs at its peak: the tensor cores, HBM and
    NVLink."""
    return {"compute_s": flops_per_dev / PEAK_FLOPS, "memory_s": bytes_per_dev / HBM_BW,
            "collective_s": coll_bytes_per_dev / NVLINK_BW}


def dominant(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
