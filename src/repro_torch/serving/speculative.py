"""Self-speculative draft-k-verify-1 decoding over the paged RaZeR KV pool
(PyTorch port of ``repro.serving.speculative``).

Each iteration spends k cheap draft passes guessing the next k tokens, then
ONE target pass scores all k+1 positions (``kernels/paged_kv_attention.py``'s
verify kernel, K5); every leading draft the target's own argmax agrees with
commits for free, and the first disagreement still yields the target's
token.  Greedy outputs equal vanilla decode by construction: verify computes,
per query, the reduction a vanilla decode step computes.

Self-speculative: the draft is the SAME checkpoint under a cheaper
``QuantPolicy`` (bf16 for a packed target, fakequant nvfp4 by default).
Draft quality only moves the accept rate; ``draft_policy`` may even be a
plain callable producing oracle or adversarial drafts.

One iteration over the running slots::

    tokens   [..committed | last]                cur_len = C
    draft    k x decode_step(draft params)       writes draft KV at C..C+k-1
    verify   1 x decode_verify(target params)    rewrites target KV at C..C+k
    accept   longest prefix drafts[t] == argmax(verify[t]), plus one
    commit   scheduler.post_verify (eos/max_new trim exactly like vanilla)
    rollback pool.truncate(rid, new C) -- rejected tail pages freed

Rollback never erases wire bytes: positions >= cur_len never attend.  The
scheduler reserves ``len(prompt) + max_new + k`` tokens of pages per request.

On a serving mesh the draft params are built from the engine's whole dense
tree and are never sharded, so the draft runs replicated on every rank; the
verify pass runs the engine's sharded params.  Both run inside the engine's
``sharding_ctx`` (``Engine.serve``), so an MoE draft picks its dispatch
groups from the mesh, as the reference's draft does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.models import transformer as tf
from repro_torch.obs import NULL_TRACER, Clock

__all__ = ["SpeculativeDecoder", "SpecStats", "resolve_draft_policy"]

# draft format when serve(speculate_k=...) has no draft_policy: fakequant
# nvfp4 -- the paper's baseline format, valid for any weight shape
DEFAULT_DRAFT_FORMAT = "nvfp4"

# a callable draft "model" (tokens, cur_lens, t) -> next draft token per slot;
# the verify pass never trusts it
DraftFn = Callable[[np.ndarray, np.ndarray, int], np.ndarray]


def resolve_draft_policy(policy_like) -> Union[QuantPolicy, DraftFn]:
    """None -> fakequant nvfp4; "bf16" -> the raw dense weights; another
    format name -> fakequant of that format; a QuantPolicy -> itself; a
    callable -> an oracle draft fn."""
    if policy_like is None:
        return QuantPolicy.fakequant(DEFAULT_DRAFT_FORMAT)
    if callable(policy_like) and not isinstance(policy_like, (QuantPolicy, type)):
        return policy_like
    if isinstance(policy_like, str):
        if policy_like == "bf16":
            return QuantPolicy.bf16()
        return QuantPolicy.fakequant(policy_like)
    if not isinstance(policy_like, QuantPolicy):
        raise TypeError(f"draft_policy must be None, a format name, a QuantPolicy or a callable, "
                        f"got {type(policy_like).__name__}")
    return policy_like


@dataclasses.dataclass
class SpecStats:
    """Accept-rate / draft-cost accounting."""

    drafted: int = 0        # draft tokens proposed (k per active slot per step)
    accepted: int = 0       # drafts the target's argmax agreed with
    draft_steps: int = 0    # draft decode passes (k per iteration)
    verify_steps: int = 0   # multi-query verify passes (1 per iteration)
    draft_time: float = 0.0   # clock seconds inside the draft loop
    verify_time: float = 0.0  # clock seconds inside verify + accept

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


def _dense_in(tree, quant: QuantPolicy, dtype: torch.dtype, path: str = ""):
    """The tree with every weight that ``quant`` (the target's policy)
    quantizes -- the linears and the expert banks -- cast to ``dtype`` once:
    the bf16 draft multiplies ``x @ w.to(x.dtype)`` at every step, so casting
    ahead gives the same products without converting the weights each pass.
    What the policy's dense rules keep at high precision (embeddings, the
    MoE router, norms) stays as it is; its consumers cast it as the
    reference does (the router runs in f32)."""
    if isinstance(tree, dict):
        return {k: _dense_in(v, quant, dtype, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dense_in(v, quant, dtype, path) for v in tree]
    if (isinstance(tree, torch.Tensor) and tree.dim() in (2, 3) and tree.is_floating_point()
            and quant.resolve(path) is not None):
        return tree.to(dtype)
    return tree


class SpeculativeDecoder:
    """Drives one engine's speculative decode iterations: the draft-side
    params (the engine's raw weights, packed for a packed draft policy, else
    quantized at forward time by the policy), the 1-token draft
    ``decode_step`` and the (k+1)-token ``decode_verify``, both over the
    pool's per-layer views, updated in place."""

    def __init__(self, engine, draft_policy=None):
        self.engine = engine
        resolved = resolve_draft_policy(draft_policy)
        if not isinstance(resolved, QuantPolicy):
            self.draft_fn: Optional[DraftFn] = resolved
            self.draft_quant = None
            self.draft_params = None
        else:
            from repro_torch.serving.engine import pack_model_weights

            self.draft_fn = None
            self.draft_quant = resolved
            raw = engine.draft_source_params()
            if resolved.mode == "packed":
                draft = pack_model_weights(raw, engine.cfg, resolved)
            elif resolved.mode == "bf16":
                draft = _dense_in(raw, engine.policy, engine.cfg.cdtype)
            else:
                draft = raw  # fakequant applies per forward through the policy
            self.draft_params = draft
        self.stats = SpecStats()
        # rebound by Engine.serve per call (the decoder is cached across calls)
        self.clock = Clock()
        self.tracer = NULL_TRACER

    @torch.no_grad()
    def decode_iteration(self, pool, sched, batch, k: int, now: Union[float, Callable[[], float]]) -> List:
        """One draft-k-verify-1 iteration over a ``decode_batch`` result.
        Commits accepted tokens through ``sched.post_verify``, rolls back
        rejected tail pages, updates ``stats``; returns the newly finished
        requests.  ``now`` may be the engine's serve-relative clock, read
        after verify."""
        eng = self.engine
        dev = eng.device
        seq_ids, tokens, cur_lens = batch
        b = len(seq_ids)
        # cover the k speculative writes (re-appends pages a previous rollback
        # returned; the scheduler's ledger keeps them reserved)
        for slot, rid in enumerate(seq_ids):
            if rid is not None:
                pool.append(rid, cur_lens[slot] + k + 1)
        page_table = pool.page_table(seq_ids)

        act = np.asarray([s is not None for s in seq_ids])
        cur = np.asarray(cur_lens, np.int32)
        tok = np.asarray(tokens, np.int32)
        drafts = np.zeros((k, b), np.int32)

        t0 = self.clock.now()
        with self.tracer.span("draft", k=k, slots=int(act.sum())):
            for t in range(k):
                # idle slots stay at position 0 (null page); their drafts
                # are garbage and their slot commits nothing
                cl_t = np.where(act, cur + t, 0).astype(np.int32)
                if self.draft_fn is not None:
                    nxt = np.asarray(self.draft_fn(tok, cl_t, t), np.int32)
                else:
                    logits, _ = tf.decode_step(self.draft_params, torch.as_tensor(tok, device=dev).long(),
                                               pool.layers, torch.as_tensor(cl_t, device=dev), eng.cfg,
                                               self.draft_quant, pages=page_table)
                    nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
                drafts[t] = nxt
                tok = nxt
        self.stats.draft_time += self.clock.now() - t0
        self.stats.draft_steps += k

        # ONE verify pass scores all k+1 positions: feed [last, d1..dk]; the
        # logits at position t predict the token at cur_len + t + 1
        t1 = self.clock.now()
        with self.tracer.span("verify", k=k, slots=int(act.sum())):
            vtok = np.concatenate([np.asarray(tokens, np.int32)[None], drafts], axis=0).T
            logits, _ = tf.decode_verify(eng.params, torch.as_tensor(vtok, device=dev).long(), pool.layers,
                                         torch.as_tensor(np.where(act, cur, 0).astype(np.int32), device=dev),
                                         eng.cfg, eng.policy, pages=page_table)
            targets = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()  # (B, k+1)
        self.stats.verify_time += self.clock.now() - t1
        self.stats.verify_steps += 1

        # greedy accept: commit targets[0..m) where m - 1 is the longest
        # prefix with drafts[t] == targets[t]; the first mismatch still
        # commits the target's own token
        commits: List[List[int]] = []
        for i in range(b):
            if not act[i]:
                commits.append([])
                continue
            m = 1
            while m <= k and drafts[m - 1, i] == targets[i, m - 1]:
                m += 1
            commits.append(targets[i, :m].tolist())
            self.stats.accepted += m - 1
        self.stats.drafted += k * int(act.sum())

        finished = sched.post_verify(commits, now() if callable(now) else now)
        # rollback: drop pages that cover only rejected positions
        for slot, req in sched.running.items():
            if seq_ids[slot] == req.rid:
                pool.truncate(req.rid, req.cur_len)
        return finished
