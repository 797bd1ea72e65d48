"""Serving engine (PyTorch port of ``repro.serving.engine``): RaZeR-packed
weights, optional W4A4 activation fake-quant, and the RaZeR-packed KV cache.

Two serving modes:

  * ``Engine.generate`` -- static batching: one ragged batch of prompts is
    right-padded to a power-of-two bucket (to its longest prompt for the
    archs that take frontend or encoder inputs), prefilled in one pass, and
    greedy-decoded over fixed (batch, max_len) caches with per-sequence
    lengths.
  * ``Engine.serve``    -- continuous batching: a ``serving.scheduler``
    admission/decode loop over the paged RaZeR KV pool
    (``serving.pagepool``), with the prefix cache on by default
    (``serving.prefixcache``) and optional self-speculative decoding
    (``serving.speculative``).

``Engine(..., mesh=)`` serves on an (ep, tp) serving mesh
(``launch.mesh.make_serving_mesh``): every rank runs the same loop on the
same requests, holds this rank's shards of the packed weights
(``parallel.sharding.shard_params``) and runs every forward inside
``sharding_ctx(mesh)``; activations, the KV cache and the host-side
scheduling are replicated, so every rank produces the same tokens.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policy import QuantPolicy, TensorSpec
from repro_torch.device import resolve_device, sync
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.obs import percentile
from repro_torch.parallel.sharding import shard_params, sharding_ctx

__all__ = ["ServeConfig", "Engine", "ServeReport", "pack_model_weights", "fakequant_model_weights"]


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    max_new_tokens: int = 32
    kv_quant: bool = False  # RaZeR KV cache (App. C.1)
    quant: QuantPolicy = dataclasses.field(default_factory=QuantPolicy.bf16)
    eos_id: int = -1  # -1: never stop early


_MIN_PACK = 16 * 16  # weights smaller than this stay dense


def _stacked_shape(leaf) -> Optional[tuple]:
    """The reference's shape of a leaf: a tensor's own, or (L, ...) for a
    ``layers_<g>`` group's per-layer tensors gathered into a list (the
    reference's scan-stacked leaf); None for anything else."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    if isinstance(leaf, list) and leaf and all(isinstance(t, torch.Tensor) for t in leaf):
        return (len(leaf),) + tuple(leaf[0].shape)
    return None


def _packable(spec: TensorSpec, shape: Optional[tuple], block_axis: int) -> bool:
    """Structural eligibility on the reference's shape: the blocked axis
    splits into whole blocks of the size the format will actually use, and
    the tensor is big enough to matter."""
    return (shape is not None and len(shape) > block_axis
            and shape[block_axis] % spec.effective_block_size == 0 and math.prod(shape) >= _MIN_PACK)


def _gather_layers(layers: list):
    """A ``layers_<g>`` list of per-layer dicts -> one dict whose leaves
    are lists of the L per-layer leaves (the reference's stacked group)."""
    if isinstance(layers[0], dict):
        return {k: _gather_layers([layer[k] for layer in layers]) for k in layers[0]}
    return list(layers)


def _split_layers(tree, n: int) -> list:
    """Inverse of ``_gather_layers``: per-layer dicts from lists of n."""
    if isinstance(tree, dict):
        parts = {k: _split_layers(v, n) for k, v in tree.items()}
        return [{k: part[i] for k, part in parts.items()} for i in range(n)]
    return tree


def _apply_policy_to_weights(params, quant: QuantPolicy, leaf_fn):
    """Shared rule-resolving tree walk: ``leaf_fn(spec, leaf)`` transforms
    every leaf whose '/'-joined path resolves to a quantizing spec.  A
    ``layers_<g>`` list walks as the reference's scan-stacked group, under
    the group's paths: ``leaf_fn`` receives each path's L per-layer tensors
    as a list and returns a list of L."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
        if isinstance(tree, list) and tree and isinstance(tree[0], dict):
            return _split_layers(walk(_gather_layers(tree), path), len(tree))
        spec = quant.resolve(path)
        return tree if spec is None else leaf_fn(spec, tree)

    return walk(params, "")


def pack_model_weights(params, cfg: ArchConfig, quant: QuantPolicy):
    """Replace every eligible weight with its format's wire container, per
    the policy's rules on the '/'-joined path.  Each layer of a
    ``layers_<g>`` list packs on its own, under the group's path, as the
    reference packs a scan-stacked leaf layer by layer.

    A spec with the ``stacked`` marker (MoE expert banks, the default
    ``*experts*`` rule) packs a whole (E, d_in, d_out) bank into the
    format's stacked container, and only when BOTH trailing dims are block
    multiples: gate/up (E, d, f) and down (E, f, d) reduce over d and f, so
    the symmetric condition packs the trio all or none, as ``moe_forward``
    needs."""

    def pack_leaf(spec: TensorSpec, leaf):
        if spec.mode != "packed":
            return leaf
        shape, per_layer = _stacked_shape(leaf), isinstance(leaf, list)
        pack = spec.pack_stacked if spec.stacked else spec.pack
        ndim = (3 if spec.stacked else 2) + per_layer
        if shape is None or len(shape) != ndim or not _packable(spec, shape, ndim - 2):
            return leaf
        if spec.stacked and shape[-1] % spec.effective_block_size:
            return leaf
        return [pack(t.to(torch.float32)) for t in leaf] if per_layer else pack(leaf.to(torch.float32))

    return _apply_policy_to_weights(params, quant, pack_leaf)


def fakequant_model_weights(params, cfg: ArchConfig, quant: QuantPolicy):
    """Offline per-layer fake-quant: quantize-dequantize every eligible
    weight under the policy's per-layer rules (the accuracy-experiment
    analogue of ``pack_model_weights``: how rule-driven mixed precision
    enters a fakequant evaluation).  A ``layers_<g>`` group's weights
    quantize as the reference's stacked leaf, one tensor blocked along
    d_in under one tensor scale.  Expert banks stay as they are: they
    fake-quantize at forward time (``moe_forward``)."""

    def qdq_leaf(spec: TensorSpec, leaf):
        shape = _stacked_shape(leaf)
        if spec.stacked or shape is None:
            return leaf
        if len(shape) == 2 and isinstance(leaf, torch.Tensor) and _packable(spec, shape, 0):
            return spec.qdq(leaf, axis=0)
        if len(shape) == 3 and isinstance(leaf, list) and _packable(spec, shape, 1):
            return list(torch.unbind(spec.qdq(torch.stack(leaf), axis=1)))
        return leaf

    return _apply_policy_to_weights(params, quant, qdq_leaf)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _on_mesh(method):
    """Run an engine method inside ``sharding_ctx`` of the engine's mesh."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with sharding_ctx(self.mesh):
            return method(self, *args, **kwargs)

    return run


class Engine:
    """``Engine(params, cfg, ServeConfig(...))`` packs ``params`` under the
    policy once and serves ``generate`` and ``serve`` on ``device`` (the GPU
    unless the caller passes ``device="cpu"``; on a ``mesh``, the mesh's
    device).  With ``mesh`` it keeps this rank's shards of the packed
    weights; the dense tree kept for the speculative draft stays whole."""

    def __init__(self, params, cfg: ArchConfig, serve_cfg: ServeConfig, *, device=None, mesh=None):
        if mesh is not None and device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        self.device = mesh.device if mesh is not None else resolve_device(device or "cuda")
        self.mesh = mesh
        self.cfg = cfg
        self.scfg = serve_cfg
        self.policy = serve_cfg.quant
        self.kv_quant = bool(serve_cfg.kv_quant or self.policy.kv is not None)
        params = _to_device(params, self.device)
        # the dense tree stays reachable for self-speculative serving: the
        # draft re-quantizes the same checkpoint under a cheaper policy
        self._raw_params = params
        if self.policy.mode == "packed":
            params = pack_model_weights(params, cfg, self.policy)
        if mesh is not None:
            params = shard_params(params, mesh)
        params = dict(params)
        # the tables are only ever read in the compute dtype (embed casts,
        # unembed casts to x's dtype), so cast them once
        for name in ("embed", "lm_head"):
            if name in params:
                params[name] = params[name].to(cfg.cdtype)
        self.params = params
        self.stats: Dict[str, Any] = {}
        # speculative decoders keyed by resolved draft policy (draft params
        # are reused across serve() calls)
        self._spec_cache: Dict[Any, Any] = {}

    def quant_audit(self, *, model: Optional[str] = None, metrics=None, trace=None, kv_audit=None):
        """Per-layer quantization audit of this engine's weights: the
        ``obs.numerics.audit_model`` report over the dense reference tree
        and, in packed mode, the wire-format tree the engine serves from
        (on a mesh, where this rank holds shards, the audit packs the whole
        tree again), computed on the engine's device."""
        from repro_torch.obs.numerics import audit_model

        packed = self.params if self.policy.mode == "packed" and self.mesh is None else None
        return audit_model(self._raw_params, self.policy, packed=packed, model=model, metrics=metrics,
                           tracer=trace, kv_audit=kv_audit)

    @staticmethod
    def _bucket(n: int, cap: Optional[int] = None) -> int:
        b = max(8, 1 << (n - 1).bit_length())
        return b if cap is None else min(b, cap)

    def _check_prompts(self, prompts: Sequence[Sequence[int]], n_new: int) -> None:
        """Refuse what the fixed caches cannot hold.  A pure SSM stack keeps
        a recurrent state, not a (max_len,) cache, so only the empty-prompt
        check applies to it, as in the reference."""
        if not prompts:
            raise ValueError("Engine.generate needs at least one prompt")
        for i, p in enumerate(prompts):
            if len(p) == 0:
                raise ValueError(f"prompt {i} is empty; every prompt needs >= 1 token")
            if not self.cfg.ssm and len(p) + n_new > self.scfg.max_len:
                raise ValueError(f"prompt {i} ({len(p)} tokens) + max_new_tokens ({n_new}) exceeds "
                                 f"ServeConfig.max_len ({self.scfg.max_len})")

    @_on_mesh
    @torch.no_grad()
    def _bucketed_prefill(self, toks: np.ndarray, lens: np.ndarray, *, max_len: int, qdq_kv: bool):
        """Prefill a batch already padded to its bucket -> (last logits, bf16 caches)."""
        last, caches, _ = tf.prefill(self.params, torch.as_tensor(toks, device=self.device), self.cfg,
                                     self.policy, max_len=max_len,
                                     last_positions=torch.as_tensor(lens, device=self.device), qdq_kv=qdq_kv)
        return last, caches

    @_on_mesh
    @torch.no_grad()
    def _prefill(self, toks: np.ndarray, lens: np.ndarray, extras: Dict[str, Any]):
        """The exact-length prefill of the archs that take ``extras``: the
        frontend's embeddings and whisper's frames ride along, and the
        attention reads the in-pass K/V (no ``qdq_kv``), as the reference's
        exact-length prefill does.  -> (last logits, bf16 caches, enc)."""
        feed = {name: torch.as_tensor(extras[name], device=self.device)
                for name in ("frontend_embeds", "enc_frames") if extras.get(name) is not None}
        return tf.prefill(self.params, torch.as_tensor(toks, device=self.device), self.cfg, self.policy,
                          max_len=self.scfg.max_len, last_positions=torch.as_tensor(lens, device=self.device),
                          **feed)

    def _quantize_caches(self, caches):
        """bf16 GQA caches -> the packed layout (App. C.1); MLA's latent
        ``{"c", "kr"}`` caches and the recurrent ``{"h", "conv"}`` states
        stay as they are, as in the reference."""
        from repro_torch.serving.kvcache import kv_quantize

        out = []
        for c in caches:
            if "k" not in c:
                out.append(c)
                continue
            kc, km = kv_quantize(c["k"], spec=self.policy.kv)
            vc, vm = kv_quantize(c["v"], spec=self.policy.kv)
            out.append({"k_codes": kc, "k_meta": km, "v_codes": vc, "v_meta": vm})
        return out

    @_on_mesh
    @torch.no_grad()
    def _decode_step(self, tok: torch.Tensor, caches, cur: torch.Tensor, enc: Optional[torch.Tensor] = None):
        return tf.decode_step(self.params, tok, caches, cur, self.cfg, self.policy, enc=enc)

    @_on_mesh
    def generate(self, prompts: Sequence[Sequence[int]], extras: Optional[Dict[str, Any]] = None,
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """Greedy-decode a batch of token prompts; ``stats`` then holds the
        host-clock seconds of the prefill and of the decode steps.

        GQA and MLA stacks prefill the batch padded to its power-of-two
        bucket.  Archs with a modality frontend, an encoder-decoder, or any
        ``extras`` ({"frontend_embeds": (B, P, d), "enc_frames": (B,
        S_enc, d)}) prefill at the exact longest length with the extras,
        attending the in-pass K/V, and whisper's encoder output goes to
        every decode step.  Whisper decodes one sequence at a time (the
        reference's position embedding fails on a batch; here a
        ``ValueError``).  The recurrent archs (Mamba-2, the RG-LRU hybrid)
        prefill at the exact length too: a padded step would enter their
        recurrent state, so their prompts must have one length."""
        n_new = max_new_tokens or self.scfg.max_new_tokens
        self._check_prompts(prompts, n_new)
        if self._recurrent() and len({len(p) for p in prompts}) != 1:
            raise ValueError("recurrent archs need equal prompt lengths")
        b = len(prompts)
        toks, lens, _ = self._prefill_input(prompts, extras)

        t0 = time.perf_counter()
        last, caches, enc = self._prefill_batch(toks, lens, extras)
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
            logits, caches = self._decode_step(tok, caches, cur, enc)
            tok = torch.argmax(logits, dim=-1)
            cur = cur + 1
            steps += 1
        t2 = time.perf_counter()
        self.stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_steps": steps,
                      "batch": b, "bucket": toks.shape[1]}
        return out

    def _recurrent(self) -> bool:
        return bool(self.cfg.ssm or self.cfg.block_pattern)

    def _bucketed(self, extras: Optional[Dict[str, Any]]) -> bool:
        return not (self._recurrent() or self.cfg.encoder_decoder or self.cfg.frontend != "none" or extras)

    def _prefill_input(self, prompts: Sequence[Sequence[int]], extras: Optional[Dict[str, Any]] = None):
        """``generate``'s prefill input: (tokens (B, S) int64 zero-padded,
        lengths (B,) int32, bucketed).  S is the power-of-two bucket of the
        longest prompt for GQA and MLA stacks, its exact length for the
        recurrent archs and archs with a frontend, an encoder-decoder or any
        ``extras``."""
        lens = np.array([len(p) for p in prompts], np.int32)
        bucketed = self._bucketed(extras)
        s = self._bucket(int(lens.max()), cap=self.scfg.max_len) if bucketed else int(lens.max())
        toks = np.zeros((len(prompts), s), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        return toks, lens, bucketed

    def _prefill_batch(self, toks: np.ndarray, lens: np.ndarray, extras: Optional[Dict[str, Any]] = None):
        """``generate``'s prefill of ``_prefill_input``'s tokens: bucketed
        (K/V through the wire format under the KV policy) or exact-length
        with the extras, then the caches packed under the KV policy.
        -> (last logits, caches, enc or None)."""
        if self._bucketed(extras):
            (last, caches), enc = self._bucketed_prefill(toks, lens, max_len=self.scfg.max_len,
                                                         qdq_kv=self.kv_quant), None
        else:
            last, caches, enc = self._prefill(toks, lens, extras or {})
        if self.kv_quant:
            caches = self._quantize_caches(caches)
        return last, caches, enc

    # -- continuous batching (paged KV pool + scheduler) ---------------------
    def draft_source_params(self):
        """The tree the speculative draft re-quantizes: the dense
        (pre-packing) tree of a packed engine, else the served params."""
        return self._raw_params if self.policy.mode == "packed" else self.params

    def _speculator(self, draft_policy):
        """Build (or reuse) the ``SpeculativeDecoder`` for a draft policy,
        keyed by the resolved policy (callable drafts by identity)."""
        from repro_torch.serving.speculative import SpeculativeDecoder, resolve_draft_policy

        resolved = resolve_draft_policy(draft_policy)
        key = resolved if isinstance(resolved, QuantPolicy) else id(resolved)
        if key not in self._spec_cache:
            self._spec_cache[key] = SpeculativeDecoder(self, draft_policy)
        return self._spec_cache[key]

    def _serve_prefill(self, prompt: Sequence[int]):
        """Prefill ONE request padded to a power-of-two bucket, attending the
        wire bytes the pool pages will hold (``qdq_kv``), which is what makes
        a prefix-cached continuation equal this uncached pass."""
        s = len(prompt)
        toks = np.zeros((1, self._bucket(s)), np.int64)
        toks[0, :s] = prompt
        return self._bucketed_prefill(toks, np.asarray([s], np.int32), max_len=toks.shape[1], qdq_kv=True)

    @torch.no_grad()
    def _prefill_range(self, prompt, start: int, end: int, pool, rid: int):
        """Prefill tokens ``[start, end)`` of ``prompt`` against the
        sequence's pool pages covering ``[0, start)``: ``start == 0`` is the
        plain bucketed prefill; otherwise the suffix (bucketed) attends the
        written pages, gathered and dequantized per layer over a
        power-of-two page count.  Returns (last logits of position
        ``end - 1``, K/V caches for ``write_prefill(..., length=end,
        start=start)``)."""
        if start == 0:
            return self._serve_prefill(prompt[:end])
        c, s = start, end - start
        ps = pool.pool_cfg.page_size
        npb = min(1 << (-(-c // ps) - 1).bit_length(), pool.pool_cfg.pages_per_seq)
        toks = np.zeros((1, self._bucket(s)), np.int64)
        toks[0, :s] = prompt[c:end]
        row = torch.from_numpy(pool.page_row(rid)[:npb]).to(self.device)
        return tf.prefill_paged_suffix(self.params, torch.as_tensor(toks, device=self.device), pool.layers, row,
                                       c, s, self.cfg, self.policy)

    @torch.no_grad()
    def _paged_decode_step(self, tokens, pool, page_table: torch.Tensor, cur_lens) -> List[int]:
        """One decode step of the slots' ``tokens`` at ``cur_lens`` over
        ``pool`` through ``page_table`` (idle slots: token 0, length 0, an
        all-null row); writes the new K/V into the pool and returns each
        slot's greedy token."""
        logits, _ = tf.decode_step(
            self.params, torch.as_tensor(tokens, device=self.device), pool.layers,
            torch.as_tensor(np.asarray(cur_lens, np.int32), device=self.device), self.cfg,
            self.policy, pages=page_table)
        return torch.argmax(logits, dim=-1).tolist()

    def _as_requests(self, requests, n_new: int):
        """Normalize a request stream (``scheduler.Request`` or raw token-id
        prompts, freely mixed) into a list of ``Request``; raw prompts get
        arrival 0, the engine's eos, and fresh rids past any explicit one."""
        from repro_torch.serving.scheduler import Request

        requests = list(requests)  # may be a generator; iterated twice below
        next_rid = max((r.rid for r in requests if isinstance(r, Request)), default=-1) + 1
        reqs: List[Request] = []
        for r in requests:
            if isinstance(r, Request):
                reqs.append(r)
            else:
                reqs.append(Request(rid=next_rid, prompt=list(r), max_new_tokens=n_new,
                                    eos_id=self.scfg.eos_id))
                next_rid += 1
        return reqs

    @_on_mesh
    def serve(self, requests, *, sched_cfg=None, pool_cfg=None, max_new_tokens: Optional[int] = None,
              prefix_cache: bool = True, speculate_k: int = 0, draft_policy=None, clock=None,
              trace=None, metrics=None, kv_audit=None, profile_dir: Optional[str] = None) -> "ServeReport":
        """Continuous batching: serve a stream of requests over the paged
        RaZeR-quantized KV pool, decoding a dynamic batch each iteration.

        ``requests`` are ``scheduler.Request``s or raw token-id prompts.  A
        request is admitted once its ``arrival`` offset (seconds from the
        call) has passed and a decode slot, pool pages for its worst case and
        the prefill token budget allow.  Greedy decode, numerically the
        ``generate`` path with a quantized KV cache.

        ``prefix_cache`` (default on) shares prompt-prefix pages through a
        radix tree over page-aligned token chunks; a hit prefills only the
        uncached suffix.  ``speculate_k > 0`` drafts ``k`` tokens per slot
        with the same checkpoint under ``draft_policy`` (default fakequant
        nvfp4) and verifies all ``k + 1`` positions in one multi-query pass,
        rolling rejected pages back with ``pool.truncate``; greedy outputs
        stay those of ``speculate_k=0``.

        Observability, all off by default:

          * ``clock``   -- an ``obs.Clock``; every timestamp and sleep of the
            loop goes through it (``obs.FakeClock`` makes latency stats
            exact in tests).  Greedy outputs never depend on it.
          * ``trace``   -- an ``obs.Tracer``; the loop records the request
            lifecycle (admit / prefill / decode_step / draft / verify /
            retire) on the serve-relative timeline.
          * ``metrics`` -- an ``obs.MetricsRegistry``; pool and cache
            occupancy export as function-backed gauges, the prefill and
            decode-step histograms fill as the loop runs, and TTFT /
            latency / per-token latency and the token counters as requests
            finish (``ServeReport.observe_into``).
          * ``kv_audit`` -- an ``obs.KVAuditor``; samples the KV
            quantization error per page at prefill-write time (read-only:
            greedy outputs are bit-identical with the hook on or off).
          * ``profile_dir`` -- bracket the loop with ``torch.profiler``
            (CPU activity, plus CUDA on the card) and write its Chrome
            trace into the directory.

        The clock is read where the JAX engine reads it, and only when
        metrics are on; on the card, with metrics or a trace on, the device
        is synchronized before a prefill's closing reads, so the prefill
        histogram and span cover its kernels (a decode step hands its
        tokens back to the host, which waits for them).

        Returns a ``ServeReport``."""
        from repro_torch.obs import NULL_TRACER, Clock
        from repro_torch.serving.pagepool import KVPagePool, PagePoolConfig, install_pool_metrics
        from repro_torch.serving.prefixcache import PrefixCache, install_cache_metrics
        from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

        sched_cfg = sched_cfg or SchedulerConfig()
        if speculate_k:
            sched_cfg = dataclasses.replace(sched_cfg, speculate_k=speculate_k)
        k = sched_cfg.speculate_k
        if k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {k}")
        spec = self._speculator(draft_policy) if k else None
        n_new = max_new_tokens or self.scfg.max_new_tokens
        reqs = self._as_requests(requests, n_new)
        if pool_cfg is None:
            ps = 16
            pages_per_seq = -(-self.scfg.max_len // ps)
            pool_cfg = PagePoolConfig(num_pages=sched_cfg.max_slots * pages_per_seq, page_size=ps,
                                      max_len=self.scfg.max_len)
        pool = KVPagePool(self.cfg, pool_cfg, device=self.device)
        if kv_audit is not None:
            pool.set_kv_audit(kv_audit)
        cache = PrefixCache(pool) if prefix_cache else None
        clock = clock if clock is not None else Clock()
        tracer = trace if trace is not None else NULL_TRACER
        sched = Scheduler(sched_cfg, pool, cache=cache, tracer=tracer)
        for r in reqs:
            sched.submit(r)

        t0 = clock.now()

        def now() -> float:
            return clock.now() - t0

        if tracer.enabled:
            # trace timestamps on the serve-relative timeline
            tracer.clock = now
            tracer.set_track(tracer.pid, tracer.tid, process="engine", thread="serve")
        if spec is not None:
            spec.clock, spec.tracer = clock, tracer
        if metrics is not None:
            install_pool_metrics(metrics, pool)
            if cache is not None:
                install_cache_metrics(metrics, cache)
            metrics.histogram("serve_decode_step_seconds", "Wall seconds per decode step", labels=("stage",))
            metrics.histogram("serve_prefill_seconds", "Wall seconds per prefill call", labels=("stage",))
        # the cached speculator accumulates stats across serve() calls;
        # report this run's delta against a snapshot
        spec_base = dataclasses.replace(spec.stats) if spec else None
        with self._profiler(profile_dir):
            decode_steps, prefill_tokens, cached_tokens, peak_pages, peak_slots = self._serve_loop(
                sched, pool, spec, k, now, clock, tracer, metrics)

        wall = now()
        report = ServeReport(
            requests=reqs, wall_time=wall, new_tokens=sum(len(r.out_tokens) for r in reqs),
            decode_steps=decode_steps, prefill_tokens=prefill_tokens,
            peak_pages=peak_pages, peak_slots=peak_slots,
            page_bytes=pool.bytes_per_page(), pool_bytes=pool.total_bytes(),
            cached_tokens=cached_tokens,
            cache_lookups=cache.lookups if cache else 0,
            cache_hits=cache.hits if cache else 0,
            cache_evictions=cache.evictions if cache else 0,
            speculate_k=k,
            drafted_tokens=spec.stats.drafted - spec_base.drafted if spec else 0,
            accepted_drafts=spec.stats.accepted - spec_base.accepted if spec else 0,
            draft_steps=spec.stats.draft_steps - spec_base.draft_steps if spec else 0,
            draft_time=spec.stats.draft_time - spec_base.draft_time if spec else 0.0,
            verify_time=spec.stats.verify_time - spec_base.verify_time if spec else 0.0,
        )
        if metrics is not None:
            report.observe_into(metrics)
        return report

    @contextlib.contextmanager
    def _profiler(self, profile_dir: Optional[str]):
        """``torch.profiler`` around the serve loop when ``profile_dir`` is
        given (CPU activity, plus CUDA on the card), its Chrome trace
        written to ``profile_dir/serve_trace.json``."""
        if not profile_dir:
            yield
            return
        import os

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
            sync(self.device)
        prof.export_chrome_trace(os.path.join(profile_dir, "serve_trace.json"))

    @torch.no_grad()
    def _serve_loop(self, sched, pool, spec, k: int, now, clock, tracer, metrics=None):
        """The continuous-batching event loop (``serve`` owns setup and the
        report).  Returns (decode_steps, prefill_tokens, cached_tokens,
        peak_pages, peak_slots)."""
        mx = metrics is not None
        if mx:
            step_h = metrics.get("serve_decode_step_seconds")
            prefill_h = metrics.get("serve_prefill_seconds")
        # a span or histogram must not close before its kernels end
        wait = (mx or tracer.enabled) and self.device.type == "cuda"
        decode_steps = prefill_tokens = cached_tokens = 0
        peak_pages = peak_slots = 0
        # slot -> pages assignments change only on admission and retirement,
        # so the device page table is kept between scheduler events
        page_table = None
        idle_retries = 0
        while sched.has_work:
            admitted = sched.admit(now())
            if not admitted and not sched.running:
                # nothing runnable yet: sleep until the next arrival, then
                # retry admission.  With nothing running the pool is empty,
                # so an arrived head always admits; repeated no-progress
                # retries past its arrival mean a broken invariant
                nxt = sched.next_arrival()
                idle_retries = idle_retries + 1 if (nxt is None or nxt <= now()) else 0
                if nxt is None or idle_retries > 1000:
                    raise RuntimeError("scheduler stalled: an arrived request cannot be admitted "
                                       "into an idle engine")
                clock.sleep(max(nxt - now(), 0.0))
                continue
            idle_retries = 0
            # prefill phase (token-budgeted; a prefix-cache hit prefills only
            # the uncached suffix and writes just the pages past the shared
            # boundary)
            by_rid = {r.rid: r for r in admitted}
            for req in admitted:
                if req.dedup_of is not None:
                    # same-batch duplicate: its donor has prefilled, so the
                    # COW copy of the partial last page can be taken; the
                    # first token is the donor's
                    pool.flush_forks(req.rid)
                    cached_tokens += req.cached_tokens
                    sched.start(req, by_rid[req.dedup_of].out_tokens[0], now())
                    continue
                if mx:
                    pt = now()
                with tracer.span("prefill", rid=req.rid, tokens=len(req.prompt) - req.cached_tokens,
                                 cached=req.cached_tokens):
                    if req.cached_tokens:
                        pool.flush_forks(req.rid)  # COW copy, after the donors' writes
                        last, caches = self._prefill_range(req.prompt, req.cached_tokens, len(req.prompt),
                                                           pool, req.rid)
                        pool.write_prefill(req.rid, caches, len(req.prompt), start=req.cached_tokens)
                    else:
                        last, caches = self._serve_prefill(req.prompt)
                        pool.write_prefill(req.rid, caches, len(req.prompt))
                    if wait:
                        sync(self.device)
                if mx:
                    prefill_h.observe(now() - pt, stage="engine")
                prefill_tokens += len(req.prompt) - req.cached_tokens
                cached_tokens += req.cached_tokens
                sched.start(req, int(torch.argmax(last[0])), now())
            if admitted:
                page_table = None
            peak_pages = max(peak_pages, pool.pages_in_use)
            peak_slots = max(peak_slots, len(sched.running))
            # decode phase: one dynamic-batch step over the active slots
            batch = sched.decode_batch()
            if batch is None:
                continue
            if mx:
                st = now()
            if spec is not None:
                # draft-k-verify-1 appends and truncates pages every
                # iteration, so no table is kept across it (its draft and
                # verify end with their tokens on the host)
                spec.decode_iteration(pool, sched, batch, k, now)
                decode_steps += 1
                page_table = None
                peak_pages = max(peak_pages, pool.pages_in_use)
                if mx:
                    step_h.observe(now() - st, stage="engine")
                continue
            seq_ids, tokens, cur_lens = batch
            with tracer.span("decode_step", batch=len(sched.running)):
                if page_table is None:
                    page_table = pool.page_table(seq_ids)
                toks = self._paged_decode_step(tokens, pool, page_table, cur_lens)
            decode_steps += 1
            if mx:
                step_h.observe(now() - st, stage="engine")
            if sched.post_decode(toks, now()):
                page_table = None  # a retirement freed a slot
        return decode_steps, prefill_tokens, cached_tokens, peak_pages, peak_slots


@dataclasses.dataclass
class ServeReport:
    """Outcome of one ``Engine.serve`` run: outputs + serving metrics."""

    requests: List[Any]
    wall_time: float
    new_tokens: int
    decode_steps: int
    prefill_tokens: int
    peak_pages: int
    peak_slots: int
    page_bytes: int
    pool_bytes: int
    # ``prefill_tokens`` counts computed prompt tokens; ``cached_tokens`` the
    # prompt tokens served from shared or copied pages (prefix-cache hits and
    # same-batch dedup, so it can be nonzero with the cache off)
    cached_tokens: int = 0
    cache_lookups: int = 0
    cache_hits: int = 0
    cache_evictions: int = 0
    # speculative decoding: with ``speculate_k > 0`` each decode step is one
    # draft-k-verify-1 iteration
    speculate_k: int = 0
    drafted_tokens: int = 0
    accepted_drafts: int = 0
    draft_steps: int = 0
    draft_time: float = 0.0
    verify_time: float = 0.0

    @property
    def outputs(self) -> List[List[int]]:
        """prompt + generated tokens per request, in submission order (the
        shape ``Engine.generate`` returns)."""
        return [list(r.prompt) + list(r.out_tokens) for r in self.requests]

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of prompt tokens served from the prefix cache."""
        total = self.cached_tokens + self.prefill_tokens
        return self.cached_tokens / total if total else 0.0

    @property
    def accept_rate(self) -> float:
        """Fraction of draft proposals the target's argmax accepted."""
        return self.accepted_drafts / self.drafted_tokens if self.drafted_tokens else 0.0

    @property
    def draft_overhead(self) -> float:
        """Fraction of speculative decode time spent drafting."""
        total = self.draft_time + self.verify_time
        return self.draft_time / total if total else 0.0

    @property
    def tokens_per_step(self) -> float:
        """Mean committed tokens per decode iteration."""
        return self.new_tokens / self.decode_steps if self.decode_steps else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.new_tokens / max(self.wall_time, 1e-9)

    # per-request samples; the percentiles are exact nearest-rank
    def ttft_values(self) -> List[float]:
        """Per-request time to first token (s), finished requests only."""
        return [r.first_token_time - r.arrival for r in self.requests if r.first_token_time is not None]

    def latency_values(self) -> List[float]:
        """Per-request total latency (s), finished requests only."""
        return [r.finish_time - r.arrival for r in self.requests if r.finish_time is not None]

    def tpot_values(self) -> List[float]:
        """Per-request mean latency per token after the first (s)."""
        return [(r.finish_time - r.first_token_time) / (len(r.out_tokens) - 1) for r in self.requests
                if r.finish_time is not None and len(r.out_tokens) > 1]

    @property
    def mean_ttft(self) -> float:
        ts = self.ttft_values()
        return sum(ts) / len(ts) if ts else 0.0

    @property
    def mean_latency(self) -> float:
        ts = self.latency_values()
        return sum(ts) / len(ts) if ts else 0.0

    def ttft_percentile(self, q: float) -> float:
        return percentile(self.ttft_values(), q)

    def latency_percentile(self, q: float) -> float:
        return percentile(self.latency_values(), q)

    def tpot_percentile(self, q: float) -> float:
        return percentile(self.tpot_values(), q)

    ttft_p50 = property(lambda self: self.ttft_percentile(50))
    ttft_p95 = property(lambda self: self.ttft_percentile(95))
    ttft_p99 = property(lambda self: self.ttft_percentile(99))
    latency_p50 = property(lambda self: self.latency_percentile(50))
    latency_p95 = property(lambda self: self.latency_percentile(95))
    latency_p99 = property(lambda self: self.latency_percentile(99))
    tpot_p50 = property(lambda self: self.tpot_percentile(50))
    tpot_p95 = property(lambda self: self.tpot_percentile(95))
    tpot_p99 = property(lambda self: self.tpot_percentile(99))

    def observe_into(self, registry, stage: str = "engine") -> None:
        """Feed the per-request latency samples into a ``MetricsRegistry``'s
        ``serve_ttft_seconds`` / ``serve_latency_seconds`` /
        ``serve_tpot_seconds`` histograms and bump the token counters: the
        registry's mirror of the report's exact percentiles.
        ``DisaggReport`` reuses this per stage."""
        ttft = registry.histogram("serve_ttft_seconds", "Time to first token", labels=("stage",))
        lat = registry.histogram("serve_latency_seconds", "Request total latency", labels=("stage",))
        tpot = registry.histogram("serve_tpot_seconds", "Per-token latency after the first", labels=("stage",))
        for v in self.ttft_values():
            ttft.observe(v, stage=stage)
        for v in self.latency_values():
            lat.observe(v, stage=stage)
        for v in self.tpot_values():
            tpot.observe(v, stage=stage)
        registry.counter("serve_tokens_total", "Committed new tokens",
                         labels=("stage",)).inc(self.new_tokens, stage=stage)
        registry.counter("serve_prefill_tokens_total", "Prompt tokens computed by prefill",
                         labels=("stage",)).inc(self.prefill_tokens, stage=stage)
        registry.counter("serve_requests_total", "Requests finished",
                         labels=("stage",)).inc(len(self.requests), stage=stage)
