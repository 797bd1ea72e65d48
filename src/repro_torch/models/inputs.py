"""Input specs for every (arch x shape x kind) cell and their materializer
(the counterpart of ``repro.models.inputs``).

A spec is a ``meta``-device tensor: a shape and a dtype, no storage.  The
modality frontends are stubs: a VLM cell gets precomputed patch embeddings
(replacing the leading positions), an audio cell precomputed frame
embeddings.  ``materialize`` draws real arrays from a numpy generator in the
reference's order, so a cell's inputs are the reference's arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ArchConfig

__all__ = ["N_IMG_PATCHES", "LayerList", "train_input_specs", "prefill_input_specs", "decode_input_specs",
           "input_specs", "materialize"]

N_IMG_PATCHES = 256  # VLM stub: patches prepended into the sequence

_META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


class LayerList(list):
    """The per-layer decode caches of a spec tree, with ``counts``: the
    layers of each layer group, which the reference stacks into one array a
    group (``materialize`` draws each group's array whole)."""

    counts: List[int]


def train_input_specs(cfg: ArchConfig, seq_len: int, global_batch: int) -> Dict[str, Any]:
    b, s = global_batch, seq_len
    specs = {"tokens": _spec((b, s), torch.int32), "labels": _spec((b, s), torch.int32)}
    if cfg.frontend == "vision":
        n = min(N_IMG_PATCHES, max(s // 4, 1))  # patches occupy a sequence prefix
        specs["frontend_embeds"] = _spec((b, n, cfg.d_model), torch.bfloat16)
        specs["positions3"] = _spec((3, b, s), torch.int32)
    if cfg.frontend == "audio":
        specs["enc_frames"] = _spec((b, cfg.enc_frames, cfg.d_model), torch.bfloat16)
    return specs


def prefill_input_specs(cfg: ArchConfig, seq_len: int, global_batch: int) -> Dict[str, Any]:
    specs = train_input_specs(cfg, seq_len, global_batch)
    del specs["labels"]
    return specs


def decode_input_specs(cfg: ArchConfig, seq_len: int, global_batch: int) -> Dict[str, Any]:
    """One new token against caches holding ``seq_len`` positions."""
    from .transformer import init_caches, layer_groups

    b = global_batch
    caches = LayerList(init_caches(cfg, b, seq_len, torch.bfloat16, device=_META))
    caches.counts = [count for _, count in layer_groups(cfg)]
    specs: Dict[str, Any] = {"token": _spec((b,), torch.int32), "caches": caches, "cur_len": _spec((), torch.int32)}
    if cfg.encoder_decoder:
        specs["enc"] = _spec((b, cfg.enc_frames, cfg.d_model), torch.bfloat16)
    return specs


def input_specs(cfg: ArchConfig, shape: dict) -> Dict[str, Any]:
    kind = shape["kind"]
    if kind == "train":
        return train_input_specs(cfg, shape["seq_len"], shape["global_batch"])
    if kind == "prefill":
        return prefill_input_specs(cfg, shape["seq_len"], shape["global_batch"])
    if kind == "decode":
        return decode_input_specs(cfg, shape["seq_len"], shape["global_batch"])
    raise ValueError(kind)


def materialize(specs, seed: int = 0, vocab: int = 256, device="cuda"):
    """Real arrays matching a spec tree, drawn from ``np.random.default_rng
    (seed)`` leaf by leaf in the order JAX walks the reference's tree (dict
    keys sorted, each layer group's caches as one stacked array):
    positions3 as three equal ``arange`` streams, integers uniform in [0,
    vocab) (a scalar: 0), floats standard normal, cast to the spec's dtype."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def draw(name, s: torch.Tensor) -> np.ndarray:
        if "positions3" in name:
            # text-only default: the three streams equal arange (decode steps
            # take positions from cur_len and must agree)
            _, b, sq = s.shape
            return np.broadcast_to(np.arange(sq, dtype=np.int32), (3, b, sq))
        if not s.dtype.is_floating_point:
            return np.zeros((), np.int32) if s.dim() == 0 else rng.integers(0, vocab, tuple(s.shape))
        return rng.standard_normal(tuple(s.shape))

    def tensor(a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)

    def make(name, s):
        if isinstance(s, dict):
            return {k: make(f"{name}/{k}", s[k]) for k in sorted(s)}
        if isinstance(s, LayerList):
            out, i = [], 0
            for n in s.counts:  # one stacked draw per group and leaf, as the reference's arrays
                group = s[i:i + n]
                leaves = {k: tensor(draw(f"{name}/{k}", _spec((n, *group[0][k].shape), group[0][k].dtype)),
                                    group[0][k].dtype) for k in sorted(group[0])}
                out += [{k: v[j] for k, v in leaves.items()} for j in range(n)]
                i += n
            return out
        return tensor(draw(name, s), s.dtype)

    return make("", specs)
