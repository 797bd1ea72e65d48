"""Static-batch serving engine (PyTorch port of ``Engine.generate`` in
``repro.serving.engine``): RaZeR-packed weights, optional W4A4 activation
fake-quant, and the RaZeR-packed KV cache.

One ragged batch of prompts is right-padded to a power-of-two bucket,
prefilled in one pass, and greedy-decoded over fixed (batch, max_len) caches
with per-sequence lengths.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policy import QuantPolicy, TensorSpec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig

__all__ = ["ServeConfig", "Engine", "pack_model_weights"]


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    max_new_tokens: int = 32
    kv_quant: bool = False  # RaZeR KV cache (App. C.1)
    quant: QuantPolicy = dataclasses.field(default_factory=QuantPolicy.bf16)
    eos_id: int = -1  # -1: never stop early


_MIN_PACK = 16 * 16  # weights smaller than this stay dense


def _packable(spec: TensorSpec, leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim == 2
            and leaf.shape[0] % spec.block_size == 0 and leaf.numel() >= _MIN_PACK)


def pack_model_weights(params, cfg: ArchConfig, quant: QuantPolicy):
    """Replace every eligible 2-D weight with its format's wire container,
    per the policy's rules on the '/'-joined path.  Each layer of the
    ``layers_0`` list packs on its own, under the group's path, so the rules
    see the paths the JAX package's stacked tree has."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        spec = quant.resolve(path)
        if spec is None or spec.mode != "packed" or not _packable(spec, tree):
            return tree
        return spec.pack(tree.to(torch.float32))

    return walk(params, "")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class Engine:
    """``Engine(params, cfg, ServeConfig(...))`` packs ``params`` under the
    policy once and serves ``generate`` on ``device`` (the GPU unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, params, cfg: ArchConfig, serve_cfg: ServeConfig, *, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.policy = serve_cfg.quant
        self.kv_quant = bool(serve_cfg.kv_quant or self.policy.kv is not None)
        params = _to_device(params, self.device)
        if self.policy.mode == "packed":
            params = pack_model_weights(params, cfg, self.policy)
        # the tables are only ever read in the compute dtype (embed casts,
        # unembed casts to x's dtype), so cast them once
        for name in ("embed", "lm_head"):
            if name in params:
                params[name] = params[name].to(cfg.cdtype)
        self.params = params
        self.stats: Dict[str, Any] = {}

    @staticmethod
    def _bucket(n: int, cap: Optional[int] = None) -> int:
        b = max(8, 1 << (n - 1).bit_length())
        return b if cap is None else min(b, cap)

    def _check_prompts(self, prompts: Sequence[Sequence[int]], n_new: int) -> None:
        if not prompts:
            raise ValueError("Engine.generate needs at least one prompt")
        for i, p in enumerate(prompts):
            if len(p) == 0:
                raise ValueError(f"prompt {i} is empty; every prompt needs >= 1 token")
            if len(p) + n_new > self.scfg.max_len:
                raise ValueError(f"prompt {i} ({len(p)} tokens) + max_new_tokens ({n_new}) exceeds "
                                 f"ServeConfig.max_len ({self.scfg.max_len})")

    @torch.no_grad()
    def _bucketed_prefill(self, toks: np.ndarray, lens: np.ndarray, *, max_len: int, qdq_kv: bool):
        """Prefill a batch already padded to its bucket -> (last logits, bf16 caches)."""
        return tf.prefill(self.params, torch.as_tensor(toks, device=self.device), self.cfg,
                          self.policy, max_len=max_len,
                          last_positions=torch.as_tensor(lens, device=self.device), qdq_kv=qdq_kv)

    def _quantize_caches(self, caches):
        """bf16 caches -> the packed layout (App. C.1)."""
        from repro_torch.serving.kvcache import kv_quantize

        out = []
        for c in caches:
            kc, km = kv_quantize(c["k"], spec=self.policy.kv)
            vc, vm = kv_quantize(c["v"], spec=self.policy.kv)
            out.append({"k_codes": kc, "k_meta": km, "v_codes": vc, "v_meta": vm})
        return out

    @torch.no_grad()
    def _decode_step(self, tok: torch.Tensor, caches, cur: torch.Tensor):
        return tf.decode_step(self.params, tok, caches, cur, self.cfg, self.policy)

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """Greedy-decode a batch of token prompts; ``stats`` then holds the
        host-clock seconds of the prefill and of the decode steps."""
        n_new = max_new_tokens or self.scfg.max_new_tokens
        self._check_prompts(prompts, n_new)
        b = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        s = self._bucket(int(lens.max()), cap=self.scfg.max_len)
        toks = np.zeros((b, s), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p

        t0 = time.perf_counter()
        last, caches = self._bucketed_prefill(toks, lens, max_len=self.scfg.max_len,
                                              qdq_kv=self.kv_quant)
        if self.kv_quant:
            caches = self._quantize_caches(caches)
        tok = torch.argmax(last, dim=-1)
        out = [list(p) for p in prompts]
        done = np.zeros(b, bool)
        cur = torch.as_tensor(lens, device=self.device)
        steps = 0
        t1 = None
        for step in range(n_new):
            for i, t in enumerate(tok.tolist()):
                if not done[i]:
                    out[i].append(t)
                    done[i] = t == self.scfg.eos_id
            if t1 is None:
                t1 = time.perf_counter()
            if done.all() or step == n_new - 1:
                break
            logits, caches = self._decode_step(tok, caches, cur)
            tok = torch.argmax(logits, dim=-1)
            cur = cur + 1
            steps += 1
        t2 = time.perf_counter()
        self.stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_steps": steps,
                      "batch": b, "bucket": s}
        return out
