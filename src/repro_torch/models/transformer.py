"""Model assembly (PyTorch port of ``repro.models.transformer``): decoder
stacks of attention layers (GQA or MLA) with a dense MLP or an MoE
feed-forward, whisper's encoder-decoder, Mamba-2 stacks and RecurrentGemma's
RG-LRU / local-attention hybrid.

Parameters are a dict: ``embed``, ``final_norm``, optionally ``lm_head``, and
one ``layers_<g>`` list of per-layer dicts per layer group (``layer_groups``:
runs of consecutive layers of one type).  An ``"a"`` layer holds ``ln1``,
``mixer`` (GQA {wq, wk, wv, wo} or MLA's projections), ``ln2`` and ``mlp``
(SwiGLU {gate, up, down} or GELU with biases); an ``"m"`` layer holds
``moe`` (router, expert banks, optional shared experts) in place of
``mlp``; a ``"c"`` layer (whisper's decoder) adds ``ln_x`` and ``xattn``,
its cross-attention; an ``"s"`` layer (Mamba-2) holds ``ln1`` and the SSD
``mixer`` only, an ``"r"`` layer the RG-LRU ``mixer`` beside ``ln2`` and
``mlp``.  An encoder-decoder also holds ``enc_layers``, a list of ``"a"``
layers, and ``enc_norm``.  The keys keep the JAX package's names
for its scan-stacked groups, so the policy rules resolve the same
'/'-joined paths (``layers_0/mixer/wq``, ``layers_1/moe/experts/gate``);
the JAX ``lax.scan`` over a group is a loop here.  Caches are one per
layer, in layer order across the groups: ``{"k", "v"}`` for GQA, the
latent ``{"c", "kr"}`` for MLA, the recurrent ``{"h", "conv"}`` state for
``"s"`` and ``"r"``.

Training runs ``forward_hidden`` (each layer checkpointed by
``REMAT_POLICY``) and ``lm_loss``; on the card the kernels on that path
(K9, K10) have backward kernels (``kernels.ops``).

Inside ``sharding_ctx`` of a train mesh ``lm_loss`` runs a dense GQA stack
under FSDP x tensor parallelism (``_lm_loss_mesh``): each rank holds its
shards of every leaf (``parallel.sharding.param_sharding_tree``), takes its
batch rows (``input_sharding``), keeps the residual stream and the norms on
its S/tp sequence rows, gathers them for attention on its H/tp query and
KVH/tp KV heads and for the MLP on its d_ff/tp columns, and scatters the
row-parallel partial sums of ``wo`` and ``down`` back to its rows
(Megatron's sequence parallelism; ``shard_activation`` at the points the
reference constrains "resid"); the cross-entropy tail is the meshless one
(``_xent``) with its two sums taken over the mesh.
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.core.qlinear import FakeQuantWeight, qlinear
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import get_ctx

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ArchConfig
from .layers import (dense_init, embed, embedding_init, gelu_mlp, gelu_mlp_init, rms_norm, swiglu, swiglu_init,
                     unembed)

__all__ = ["layer_groups", "init_params", "init_caches", "encode", "forward_hidden", "forward_train", "lm_loss",
           "prefill", "prefill_paged_suffix", "decode_step", "decode_verify", "AUX_COEF", "REMAT_POLICY",
           "check_train_mesh", "train_placement"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
AUX_COEF = 0.01  # weight of the MoE load-balance loss in lm_loss

# What the training forward keeps of each layer for the backward:
#   "full" -- nothing but the layer's input: the backward recomputes the
#             layer (least memory)
#   "dots" -- the outputs of the linears' matmuls (aten.mm / addmm: the
#             reference's dots without batch dims), everything else
#             recomputed
#   "none" -- everything (no recompute, most memory)
REMAT_POLICY = contextvars.ContextVar("REMAT_POLICY", default="full")


def layer_groups(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """[(block_type, count)] for runs of consecutive same-type layers: "a"
    attention + dense MLP, "m" attention + MoE (after ``first_dense_layers``
    dense ones), "c" whisper's decoder block with cross-attention, "s"
    Mamba-2's SSD mixer alone, "r" RG-LRU + MLP (``cfg.layer_types``)."""
    types = list(cfg.layer_types)
    if cfg.moe:
        nd = cfg.first_dense_layers
        types = ["a"] * nd + ["m"] * (cfg.num_layers - nd)
    if cfg.encoder_decoder:
        types = ["c"] * cfg.num_layers
    groups: List[Tuple[str, int]] = []
    for t in types:
        if groups and groups[-1][0] == t:
            groups[-1] = (t, groups[-1][1] + 1)
        else:
            groups.append((t, 1))
    return groups


def _layers(params, cfg: ArchConfig) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """(block type, layer params) of every layer, in order across groups."""
    for gi, (ltype, _) in enumerate(layer_groups(cfg)):
        for lp in params[f"layers_{gi}"]:
            yield ltype, lp


def _mlp(x: torch.Tensor, lp, cfg: ArchConfig, quant: QuantPolicy) -> torch.Tensor:
    return (gelu_mlp if cfg.act_fn == "gelu" else swiglu)(x, lp["mlp"], quant)


def _ffn(x: torch.Tensor, lp, ltype: str, cfg: ArchConfig, quant: QuantPolicy) -> torch.Tensor:
    """The residual feed-forward half of a layer: the MLP or MoE (none in
    an "s" layer)."""
    if ltype == "s":
        return x
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if ltype == "m":
        y, _ = moe_mod.moe_forward(h2, lp["moe"], cfg, quant=quant)
        return x + y
    return x + _mlp(h2, lp, cfg, quant)


def _cross(x: torch.Tensor, lp, ltype: str, cfg: ArchConfig, quant: QuantPolicy, enc) -> torch.Tensor:
    """A "c" layer's residual cross-attention to the encoder output."""
    if ltype != "c" or enc is None:
        return x
    return x + attn.cross_forward(rms_norm(x, lp["ln_x"], cfg.norm_eps), enc, lp["xattn"], cfg, quant=quant)


def _layer_fwd(x: torch.Tensor, lp, cfg: ArchConfig, ltype: str, quant: QuantPolicy, positions: torch.Tensor,
               positions3: Optional[torch.Tensor], enc: Optional[torch.Tensor] = None):
    """A full-sequence layer -> (x, aux): the mixer (GQA or MLA attention,
    causal, a hybrid's "a" layers windowed; the SSD or RG-LRU block), the
    cross-attention of a "c" layer, then the MLP or MoE, whose
    load-balance loss is ``aux`` (0 elsewhere)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if ltype == "s":
        mix = ssm_mod.mamba2_forward(h, lp["mixer"], cfg, quant=quant)
    elif ltype == "r":
        mix = ssm_mod.rglru_forward(h, lp["mixer"], cfg, quant=quant)
    elif cfg.mla:
        mix = attn.mla_forward(h, lp["mixer"], cfg, quant=quant, positions=positions)
    else:
        mix = attn.gqa_forward(h, lp["mixer"], cfg, quant=quant, positions=positions, positions3=positions3,
                               window=_window(cfg, ltype))
    x = _cross(x + mix, lp, ltype, cfg, quant, enc)
    if ltype == "m":
        y, aux = moe_mod.moe_forward(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["moe"], cfg, quant=quant)
        return x + y, aux
    return _ffn(x, lp, ltype, cfg, quant), aux


def _gqa_init(gen: torch.Generator, cfg: ArchConfig, device) -> Dict[str, Any]:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.pdtype
    w = lambda i, o: dense_init(gen, i, o, device=device, dtype=dt)  # noqa: E731
    mixer = {"wq": w(d, cfg.num_heads * hd), "wk": w(d, cfg.num_kv_heads * hd),
             "wv": w(d, cfg.num_kv_heads * hd), "wo": w(cfg.num_heads * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads), ("bv", cfg.num_kv_heads)):
            mixer[name] = torch.zeros(width * hd, dtype=dt, device=device)
    if cfg.qk_norm:
        mixer["q_norm"] = torch.zeros(hd, dtype=dt, device=device)
        mixer["k_norm"] = torch.zeros(hd, dtype=dt, device=device)
    return mixer


def _mixer_init(gen: torch.Generator, cfg: ArchConfig, ltype: str, device) -> Dict[str, Any]:
    if ltype == "s":
        return ssm_mod.mamba2_init(gen, cfg, device=device, dtype=cfg.pdtype)
    if ltype == "r":
        return ssm_mod.rglru_init(gen, cfg, device=device, dtype=cfg.pdtype)
    return attn.mla_init(gen, cfg, device=device, dtype=cfg.pdtype) if cfg.mla else _gqa_init(gen, cfg, device)


def _layer_init(gen: torch.Generator, cfg: ArchConfig, ltype: str, device) -> Dict[str, Any]:
    d, dt = cfg.d_model, cfg.pdtype
    p = {"ln1": torch.zeros(d, dtype=dt, device=device), "mixer": _mixer_init(gen, cfg, ltype, device)}
    if ltype == "s":  # the SSD mixer has no MLP
        return p
    p["ln2"] = torch.zeros(d, dtype=dt, device=device)
    if ltype == "m":
        p["moe"] = moe_mod.moe_init(gen, cfg, device=device, dtype=dt)
    elif cfg.act_fn == "gelu":
        p["mlp"] = gelu_mlp_init(gen, d, cfg.d_ff, device=device, dtype=dt)
    else:
        p["mlp"] = swiglu_init(gen, d, cfg.d_ff, device=device, dtype=dt)
    if ltype == "c":
        p["ln_x"] = torch.zeros(d, dtype=dt, device=device)
        p["xattn"] = attn.cross_init(gen, cfg, device=device, dtype=dt)
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random full-precision parameters drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  (The JAX package draws other
    numbers from its keys; tests carry its weights over with ``bridge``.)
    On the ``meta`` device it builds the shapes alone."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"the port runs the families {FAMILIES}, got {cfg.family!r}")
    device = resolve_device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, device=device, dtype=cfg.pdtype),
        "final_norm": torch.zeros(cfg.d_model, dtype=cfg.pdtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model, device=device, dtype=cfg.pdtype)
    for gi, (ltype, count) in enumerate(layer_groups(cfg)):
        p[f"layers_{gi}"] = [_layer_init(gen, cfg, ltype, device) for _ in range(count)]
    if cfg.encoder_decoder:
        p["enc_layers"] = [_layer_init(gen, cfg, "a", device) for _ in range(cfg.enc_layers)]
        p["enc_norm"] = torch.zeros(cfg.d_model, dtype=cfg.pdtype, device=device)
    return p


def _cache_init(cfg: ArchConfig, ltype: str, batch: int, max_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    if ltype == "s":
        return ssm_mod.mamba2_state_init(cfg, batch, device=device, dtype=dtype)
    if ltype == "r":
        return ssm_mod.rglru_state_init(cfg, batch, device=device, dtype=dtype)
    if cfg.mla:
        return attn.mla_cache_init(cfg, batch, max_len, device=device, dtype=dtype)
    return {n: torch.zeros((batch, max_len, cfg.num_kv_heads, cfg.hd), dtype=dtype, device=device) for n in ("k", "v")}


def init_caches(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """Empty decode state, one entry per layer: bf16 ``{"k", "v"}`` (GQA)
    or ``{"c", "kr"}`` (MLA) of ``max_len`` positions, or the ``{"h",
    "conv"}`` recurrent state of an "s" or "r" layer (h float32)."""
    device = resolve_device(device)
    return [_cache_init(cfg, ltype, batch, max_len, dtype, device) for ltype, count in layer_groups(cfg)
            for _ in range(count)]


def _head(params) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["embed"]


def _qdq_kv(x: torch.Tensor, hd: int) -> torch.Tensor:
    """Quantize-dequantize through the KV wire format (App. C.1)."""
    from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

    return kv_dequantize(*kv_quantize(x), hd)


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    """Whisper's (s, d) sinusoid position table: sin then cos halves."""
    pos = torch.arange(s, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoid row of one decode position -> (d,).  The reference
    divides the position vector by the (d / 2,) frequencies, which
    broadcasts only for one sequence: a batch of several fails there
    (``TypeError`` in JAX), so this raises for one."""
    if pos.numel() != 1:
        raise ValueError(f"whisper's decode step takes one sequence: the reference's sinusoid position embedding "
                         f"(transformer._sinusoid_at) broadcasts a batch's {pos.numel()} positions against the "
                         f"{d // 2} frequencies and fails; generate one prompt at a time")
    dim = torch.arange(d // 2, device=pos.device, dtype=torch.float32)
    ang = pos.reshape(1).to(torch.float32) / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params, frames: torch.Tensor, cfg: ArchConfig, quant: QuantPolicy = BF16) -> torch.Tensor:
    """Whisper's encoder: frames (B, S_enc, d_model), the frontend stub's
    frame embeddings, plus sinusoid positions, through ``enc_layers``
    (attention without a causal mask or rope, GELU MLP) and ``enc_norm``."""
    b, s, _ = frames.shape
    x = frames.to(cfg.cdtype) + _sinusoid(s, cfg.d_model, frames.device).to(cfg.cdtype)
    positions = torch.arange(s, device=frames.device).expand(b, s)
    for lp in params["enc_layers"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn.gqa_forward(h, lp["mixer"], cfg, quant=quant, positions=positions, causal=False)
        x = x + _mlp(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg, quant)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dots_saved():
    """The "dots" remat policy: keep the linears' matmul outputs."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _remat():
    """-> run(layer, x): ``layer(x)`` checkpointed as ``REMAT_POLICY`` says
    (torch's non-reentrant ``checkpoint``; "none" runs it plainly)."""
    policy = REMAT_POLICY.get()
    if policy not in ("full", "dots", "none"):
        raise ValueError(f"REMAT_POLICY must be full, dots or none, got {policy!r}")
    if policy == "none":
        return lambda layer, x: layer(x)
    kw = {"context_fn": _dots_saved} if policy == "dots" else {}
    return lambda layer, x: torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False, **kw)


def _embed_inputs(params, tokens: torch.Tensor, cfg: ArchConfig, frontend_embeds: Optional[torch.Tensor]):
    """The token embeddings in the compute dtype, the leading rows and
    positions replaced by ``frontend_embeds`` (B', P, d) (the vision stub)."""
    x = embed(tokens, params["embed"], cfg.cdtype)
    if frontend_embeds is not None:
        fe = frontend_embeds.to(device=tokens.device, dtype=x.dtype)
        x[:fe.shape[0], :fe.shape[1]] = fe
    return x


def forward_hidden(params, tokens: torch.Tensor, cfg: ArchConfig, quant: QuantPolicy = BF16, *,
                   positions3: Optional[torch.Tensor] = None, frontend_embeds: Optional[torch.Tensor] = None,
                   enc_frames: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (final hidden states (B, S, d), the summed MoE aux
    loss), each layer checkpointed as ``REMAT_POLICY`` says (torch's
    non-reentrant ``checkpoint``: the backward recomputes the layer from
    its input)."""
    b, s = tokens.shape
    dev = tokens.device
    x = _embed_inputs(params, tokens, cfg, frontend_embeds)
    positions = torch.arange(s, device=dev).expand(b, s)
    enc = None
    if cfg.encoder_decoder:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: the forward needs enc_frames (B, S_enc, d_model)")
        enc = encode(params, enc_frames.to(dev), cfg, quant)
        x = x + _sinusoid(s, cfg.d_model, dev).to(x.dtype)
    remat = _remat()
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for ltype, lp in _layers(params, cfg):
        def layer(x, _lt=ltype, _lp=lp):
            return _layer_fwd(x, _lp, cfg, _lt, quant, positions, positions3, enc)

        x, aux = remat(layer, x)
        aux_total = aux_total + aux
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total


def forward_train(params, tokens: torch.Tensor, cfg: ArchConfig, quant: QuantPolicy = BF16, **kw):
    """tokens (B, S) -> (logits (B, S, V), aux loss)."""
    x, aux = forward_hidden(params, tokens, cfg, quant, **kw)
    return unembed(x, _head(params)), aux


def lm_loss(params, batch, cfg: ArchConfig, quant: QuantPolicy = BF16):
    """batch: dict(tokens (B, S), labels (B, S), optional mask,
    frontend_embeds, positions3, enc_frames) -> (loss, {"xent", "aux"}).

    The reference's memory-lean cross-entropy: loss = logsumexp(logits) -
    <x, head[label]>; the logits (B, S, V) in the compute dtype feed an f32
    logsumexp, and the label logit comes from a gather of head rows, (B,
    S, d), never a second vocab-wide buffer.  Inside ``sharding_ctx`` of a
    train mesh ``params`` are this rank's shards, ``batch`` the global
    batch, and the loss the mesh's (``_lm_loss_mesh``)."""
    mesh = get_ctx()
    if mesh is not None:
        return _lm_loss_mesh(params, batch, cfg, quant, mesh)
    x, aux = forward_hidden(params, batch["tokens"], cfg, quant, positions3=batch.get("positions3"),
                            frontend_embeds=batch.get("frontend_embeds"), enc_frames=batch.get("enc_frames"))
    loss = _xent(x, _head(params), batch["labels"], batch.get("mask"))
    return loss + AUX_COEF * aux, {"xent": loss, "aux": aux}


def _xent(x, head, labels, mask, total=lambda t: t):
    """The masked mean of logsumexp(x @ head.T) - <x, head[label]> over
    x's rows: the sum of the losses and the sum of the mask each through
    ``total`` (the identity meshless; on a mesh the sum over every batch
    and sequence shard, the reference's global normalizer)."""
    head = head.to(x.dtype)
    logits = x @ head.T
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)  # (B, S)
    ll = torch.einsum("bsd,bsd->bs", x.to(torch.float32), head[labels.long()].to(torch.float32))
    mask = torch.ones_like(lse) if mask is None else mask.to(torch.float32)
    return total(torch.sum((lse - ll) * mask)) / torch.clamp(total(torch.sum(mask)), min=1.0)


# ---------------------------------------------------------------------------
# training on a mesh: a dense GQA stack under FSDP x TP with sequence
# parallelism
# ---------------------------------------------------------------------------
_COLUMNS = ("wq", "wk", "wv", "gate", "up")  # d_out over the model axis: this rank's heads, FFN columns
_ROWS = ("wo", "down")  # d_in over the model axis: the row-parallel half, partial sums
_COLUMN_BIASES = ("bq", "bk", "bv")


def check_train_mesh(cfg: ArchConfig, mesh, quant: QuantPolicy = BF16) -> None:
    """Raise a ValueError naming the cause unless the port can train
    ``cfg`` under ``quant`` on ``mesh``: a dense GQA decoder with a SwiGLU
    MLP (MoE, MLA, the recurrent archs and the frontends train meshless);
    query heads, KV heads and d_ff each split evenly over the model axis;
    under W4A4 each rank's slice of ``wo``'s and ``down``'s input (H/tp x
    hd, d_ff/tp) a whole number of the activation quantizer's blocks,
    which run along that dim."""
    types = {t for t, _ in layer_groups(cfg)}
    if types != {"a"} or cfg.mla or cfg.moe or cfg.mrope or cfg.encoder_decoder or cfg.act_fn == "gelu":
        raise ValueError(f"the port trains dense GQA decoders with a SwiGLU MLP on a mesh, not {cfg.name} "
                         f"(layer types {sorted(types)}, mla={cfg.mla}, moe={cfg.moe}): mesh training of MoE, MLA, "
                         f"the recurrent archs and the frontends is not ported; train it meshless (mesh=None)")
    tp = mesh.tp
    for what, n in (("query heads", cfg.num_heads), ("KV heads", cfg.num_kv_heads), ("FFN columns (d_ff)", cfg.d_ff)):
        if n % tp:
            raise ValueError(f"cannot split the {n} {what} of {cfg.name} over the model axis of size {tp}: each "
                             f"rank runs an equal share of them -- choose a model axis that divides {n}")
    if quant.weight.mode == "packed":
        raise ValueError("training takes dense or fake-quantized weights, not packed ones")
    if quant.act is not None and quant.weight.quantizes:
        block = quant.act.effective_block_size
        for what, n in (("wo's input (query heads/tp x hd)", cfg.num_heads // tp * cfg.hd),
                        ("down's input (d_ff/tp)", cfg.d_ff // tp)):
            if n % block:
                raise ValueError(f"cannot split {what} = {n} into whole {block}-element blocks of the W4A4 "
                                 f"activation quantizer on a model axis of size {tp}: its blocks run along that "
                                 f"dim, so each rank's slice must hold whole blocks -- choose a model axis that "
                                 f"keeps {n} a multiple of {block}")


@functools.lru_cache(maxsize=16)
def _placement(cfg: ArchConfig, axes: Tuple[Tuple[str, int], ...]):
    from repro_torch.parallel.sharding import ServingMesh, param_sharding_tree

    shape = dict(axes)
    view = ServingMesh(ep=shape.get("data", 1), tp=shape.get("model", 1), data_index=0, model_index=0,
                       device=torch.device("meta"), backend="none", pod=shape.get("pod", 1),
                       axis_names=tuple(shape))
    return param_sharding_tree(init_params(cfg, device="meta"), view)


def train_placement(cfg: ArchConfig, mesh):
    """The ``Placement`` tree of ``cfg``'s parameters on ``mesh`` (the
    reference's ``param_sharding_tree`` of its global shapes)."""
    return _placement(cfg, tuple(mesh.shape.items()))


def _part(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def _gathered(t: torch.Tensor, place, mesh, keep: Tuple[int, ...] = ()) -> torch.Tensor:
    """``t``, this rank's shard, gathered over the axes that split its dims
    (but ``keep``), with autograd: the gradient is reduce-scattered back to
    the shard."""
    from repro_torch.parallel.collectives import gather_dim

    for d in range(t.ndim):
        ax = place.axis(d)
        if ax is not None and d not in keep:
            t = gather_dim(t, d, mesh.group(ax))
    return t


def _mesh_weight(w: torch.Tensor, place, mesh, rows: bool, wspec):
    """This rank's compute slice of a linear's weight: its d_out/tp columns
    (``rows`` False: column-parallel) or its d_in/tp rows (``rows`` True:
    row-parallel).  The FSDP shard is gathered over the data axis; a
    row-parallel weight, and any weight under weight QAT, is gathered whole
    over the model axis too.  QAT quantizes the whole weight (the tensor
    scale is the whole tensor's absmax; its 16-blocks run along d_in, so
    the data axis may split d_in anywhere) and keeps the slice, as a
    ``FakeQuantWeight``.  The gathered weight lives in this rank's layer
    for the forward only: under remat the backward's recompute gathers it
    again, so one layer's gathered weights are alive at a time (at
    llama3_2_3b's widths a layer's whole weights are 100.7 M elements,
    403 MB in f32; wo and down are whole on every rank, and under QAT
    all seven)."""
    whole = rows or wspec is not None
    w = _gathered(w, place, mesh, keep=() if whole or place.axis(1) != "model" else (1,))
    if wspec is not None:
        w = wspec.qdq(w, axis=0)
    if rows:
        w = _part(w, 0, mesh.tp, mesh.model_index)
    elif whole or place.axis(1) != "model":
        w = _part(w, 1, mesh.tp, mesh.model_index)
    return FakeQuantWeight(w) if wspec is not None else w


def _mesh_layer(lp, place, mesh, wspec):
    """One layer's parameters in compute layout (``_mesh_weight``; the
    column-parallel biases sliced to this rank's columns, norms whole)."""
    out = {}
    for k, v in lp.items():
        if isinstance(v, dict):
            out[k] = _mesh_layer(v, place[k], mesh, wspec)
        elif k in _COLUMNS or k in _ROWS:
            out[k] = _mesh_weight(v, place[k], mesh, k in _ROWS, wspec)
        elif k in _COLUMN_BIASES:
            out[k] = _part(_gathered(v, place[k], mesh), 0, mesh.tp, mesh.model_index)
        else:
            out[k] = _gathered(v, place[k], mesh)
    return out


def _lm_loss_mesh(params, batch, cfg: ArchConfig, quant: QuantPolicy, mesh):
    """``lm_loss`` on a train mesh.  This rank's rows of the global batch
    (``input_sharding``: a batch that does not divide is replicated, and
    the train step scales the gradient by the replicas), its S/tp
    sequence rows; the loss is the sum of (lse - ll) * mask over the local
    rows, summed over every batch and sequence shard, over the mask summed
    the same way: the reference's global normalizer, the same number on
    every rank."""
    from repro_torch.parallel.collectives import gather_dim, group_sum
    from repro_torch.parallel.sharding import input_sharding, shard_activation

    extra = set(batch) - {"tokens", "labels", "mask"}
    if extra:
        raise ValueError(f"training on a mesh takes tokens, labels and mask, not {sorted(extra)}")
    check_train_mesh(cfg, mesh, quant)
    place = train_placement(cfg, mesh)
    b, s = batch["tokens"].shape
    rows = input_sharding(mesh, (b, s))
    local = {k: rows.local(v, mesh) for k, v in batch.items()}
    tokens = local["tokens"]
    b, dev = tokens.shape[0], tokens.device
    wspec = quant.weight if quant.weight.quantizes and quant.weight.mode == "fakequant" else None
    table = _gathered(params["embed"], place["embed"], mesh)
    x = shard_activation(embed(tokens, table, cfg.cdtype), mesh=mesh)
    positions = torch.arange(s, device=dev).expand(b, s)
    tp = mesh.tp
    lcfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                               d_ff=cfg.d_ff // tp, head_dim=cfg.hd)
    model = mesh.group("model")
    remat = _remat()
    layer_places = [pl for gi in range(len(layer_groups(cfg))) for pl in place[f"layers_{gi}"]]
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for (_, lp), lpl in zip(_layers(params, cfg), layer_places):
        def layer(x, _lp=lp, _pl=lpl):
            w = _mesh_layer(_lp, _pl, mesh, wspec)
            h = gather_dim(rms_norm(x, w["ln1"], cfg.norm_eps), 1, model)
            mix = attn.gqa_forward(h, w["mixer"], lcfg, quant=quant, positions=positions)
            x = x + shard_activation(mix, partial=True, mesh=mesh)
            h = gather_dim(rms_norm(x, w["ln2"], cfg.norm_eps), 1, model)
            return x + shard_activation(_mlp(h, w, lcfg, quant), partial=True, mesh=mesh), aux

        x, _ = remat(layer, x)
    x = rms_norm(x, _gathered(params["final_norm"], place["final_norm"], mesh), cfg.norm_eps)
    head = table if "lm_head" not in params else _gathered(params["lm_head"], place["lm_head"], mesh)
    mask = local.get("mask")
    shards = mesh.group(rows.split_axes() + ("model",))
    # the logits (b, S/tp, V): the reference's "logits" rule's sequence rows, the head whole
    loss = _xent(x, head, _part(local["labels"], 1, tp, mesh.model_index),
                 None if mask is None else _part(mask, 1, tp, mesh.model_index), lambda t: group_sum(t, shards))
    return loss + AUX_COEF * aux, {"xent": loss, "aux": aux}


def prefill(params, tokens: torch.Tensor, cfg: ArchConfig, quant: QuantPolicy = BF16, *,
            max_len: int, positions3: Optional[torch.Tensor] = None, frontend_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None, last_positions: Optional[torch.Tensor] = None,
            qdq_kv: bool = False):
    """Run the whole prompt (B, S) and build the caches.

    Returns (last_logits (B, V), caches, enc): per layer a bf16 ``{"k",
    "v"}`` dict of (B, max_len, KVH, hd), or MLA's ``{"c", "kr"}`` latent
    cache; ``enc`` is the encoder output (whisper, from ``enc_frames``),
    which every decode step reads, else None.  ``last_positions`` (B,) are
    the true prompt lengths of a right-padded batch.  ``frontend_embeds``
    (B', P, d) replace the embeddings of the leading rows and positions
    (the vision stub); ``positions3`` (3, B, S) are M-RoPE's streams.  With
    ``qdq_kv`` the GQA layers attend the quantize-dequantized K/V, the
    values the packed cache will hold (MLA layers attend their own)."""
    b, s = tokens.shape
    dev = tokens.device
    x = _embed_inputs(params, tokens, cfg, frontend_embeds)
    positions = torch.arange(s, device=dev).expand(b, s)
    enc = None
    if cfg.encoder_decoder:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: prefill needs enc_frames (B, S_enc, d_model)")
        enc = encode(params, enc_frames.to(dev), cfg, quant)
        x = x + _sinusoid(s, cfg.d_model, dev).to(x.dtype)
    caches: List[Dict[str, torch.Tensor]] = []
    for ltype, lp in _layers(params, cfg):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if ltype in ("s", "r"):
            mix, cache = (ssm_mod.mamba2_prefill if ltype == "s" else ssm_mod.rglru_prefill)(h, lp["mixer"], cfg,
                                                                                            quant)
            x = x + mix
        elif cfg.mla:
            c, kr = attn._mla_ckv(h, lp["mixer"], cfg, quant, positions)
            x = x + attn.mla_forward(h, lp["mixer"], cfg, quant=quant, positions=positions, ckv=(c, kr))
            cache = attn.mla_cache_init(cfg, b, max_len, device=dev, dtype=cfg.cdtype)
            cache["c"][:, :s] = c
            cache["kr"][:, :s] = kr
        else:
            q, k, v = attn._qkv(h, lp["mixer"], cfg, quant, positions, positions3)
            k = k.to(cfg.cdtype)
            v = v.to(cfg.cdtype)
            if qdq_kv:
                k_att, v_att = _qdq_kv(k, cfg.hd), _qdq_kv(v, cfg.hd)
            else:
                k_att, v_att = k, v
            mix = attn.chunked_attention(q, k_att, v_att, causal=True, window=_window(cfg, ltype))
            x = x + qlinear(mix.reshape(b, s, -1), lp["mixer"]["wo"], quant)
            cache = _cache_init(cfg, ltype, b, max_len, cfg.cdtype, dev)
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
        caches.append(cache)
        x = _ffn(_cross(x, lp, ltype, cfg, quant, enc), lp, ltype, cfg, quant)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_positions is not None:
        idx = torch.as_tensor(last_positions, device=dev).long() - 1
        x_last = x[torch.arange(b, device=dev), idx][:, None]
    else:
        x_last = x[:, -1:]
    return unembed(x_last, _head(params))[:, 0], caches, enc


def _window(cfg: ArchConfig, ltype: str) -> int:
    """The sliding window of a layer's attention: the config's for the "a"
    layers of a block-pattern hybrid, else 0 (full)."""
    return cfg.window if ltype == "a" and cfg.block_pattern else 0


def _gqa_stack_only(cfg: ArchConfig, what: str) -> None:
    """The paged paths run stacks of "a" and "m" layers only: ``what``
    (the reference's words) and the first other layer type raise."""
    for ltype, _ in layer_groups(cfg):
        if ltype not in ("a", "m"):
            raise ValueError(f"{what}, got layer type {ltype!r} (serving/pagepool.py rejects these archs)")


def prefill_paged_suffix(params, tokens: torch.Tensor, pool_caches, page_row: torch.Tensor, pre_len: int,
                         sfx_len: int, cfg: ArchConfig, quant: QuantPolicy = BF16):
    """Continuation prefill of a prefix-cached request.

    ``tokens`` (1, S_b) is the uncached suffix padded to a bucket, at
    positions ``[pre_len, pre_len + sfx_len)``; ``page_row`` (NP_b,) holds
    the leading pages of this sequence, enough to cover the cached prefix;
    ``pool_caches`` is the pool's per-layer list of views.  Per layer the
    attended buffer is ``[gathered pages | suffix bucket]``: the pages are
    gathered and dequantized into a ``C = NP_b * page_size`` prefix, and the
    suffix K/V, quantize-dequantized through the wire format as
    ``prefill(qdq_kv=True)`` does, is written at offset ``pre_len``.  Every
    entry's position is its index, so causal masking with ``q_offset =
    pre_len`` hides the stale page bytes, the bucket padding and the copied
    page's stale tail: all sit past the last valid query.

    Returns (last logits (1, V), the suffix K/V caches), which the caller
    writes with ``write_prefill(..., start=pre_len)``."""
    from repro_torch.serving.kvcache import kv_dequantize

    _gqa_stack_only(cfg, "prefix-cached prefill supports GQA attention stacks only")
    b, s = tokens.shape
    dev = tokens.device
    kvh, hd = cfg.num_kv_heads, cfg.hd
    rows = page_row.long()
    c_width = rows.shape[0] * pool_caches[0]["k_codes"].shape[1]
    x = embed(tokens, params["embed"], cfg.cdtype)
    positions = pre_len + torch.arange(s, device=dev).expand(b, s)
    caches: List[Dict[str, torch.Tensor]] = []
    for (ltype, lp), pool in zip(_layers(params, cfg), pool_caches):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn._qkv(h, lp["mixer"], cfg, quant, positions)
        k = k.to(cfg.cdtype)
        v = v.to(cfg.cdtype)

        def kv_buffer(sfx, codes, meta):
            pre = kv_dequantize(codes[rows], meta[rows], hd).reshape(1, c_width, kvh, hd)
            buf = torch.cat([pre, torch.zeros_like(sfx, dtype=pre.dtype)], dim=1)
            buf[:, pre_len:pre_len + s] = sfx
            return buf

        k_all = kv_buffer(_qdq_kv(k, hd), pool["k_codes"], pool["k_meta"])
        v_all = kv_buffer(_qdq_kv(v, hd), pool["v_codes"], pool["v_meta"])
        mix = attn.chunked_attention(q, k_all, v_all, causal=True, q_offset=pre_len)
        x = x + qlinear(mix.reshape(b, s, -1), lp["mixer"]["wo"], quant)
        x = _ffn(x, lp, ltype, cfg, quant)
        caches.append({"k": k, "v": v})
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x[:, sfx_len - 1:sfx_len], _head(params))[:, 0], caches


def decode_step(params, token: torch.Tensor, caches, cur_len: torch.Tensor, cfg: ArchConfig,
                quant: QuantPolicy = BF16, *, enc: Optional[torch.Tensor] = None,
                positions3: Optional[torch.Tensor] = None, pages: Optional[torch.Tensor] = None):
    """token (B,) at positions ``cur_len`` (B,) -> (logits (B, V), caches);
    the caches are updated in place.  ``enc``: the encoder output prefill
    returned (whisper's cross-attention reads it every step);
    ``positions3`` (3, B, 1): M-RoPE's streams.  With ``pages`` (B, NP) the
    caches are the paged pool's per-layer views and every layer shares the
    table (GQA only).  An "s" or "r" layer steps its recurrent state; a
    hybrid's "a" layers attend their window."""
    x = embed(token[:, None], params["embed"], cfg.cdtype)
    if cfg.encoder_decoder:
        x = x + _sinusoid_at(torch.as_tensor(cur_len, device=x.device), cfg.d_model).to(x.dtype)[None, None, :]
    for i, (ltype, lp) in enumerate(_layers(params, cfg)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if ltype in ("s", "r"):
            if pages is not None:
                raise ValueError("paged KV decode supports GQA attention only (not "
                                 + ("SSM" if ltype == "s" else "RG-LRU") + " state)")
            step = ssm_mod.mamba2_decode if ltype == "s" else ssm_mod.rglru_decode
            mix, caches[i] = step(h, lp["mixer"], cfg, caches[i], quant=quant)
        elif cfg.mla:
            if pages is not None:
                raise ValueError("paged KV decode supports GQA attention only (not MLA)")
            mix, caches[i] = attn.mla_decode(h, lp["mixer"], cfg, caches[i], cur_len, quant=quant)
        else:
            mix, caches[i] = attn.gqa_decode(h, lp["mixer"], cfg, caches[i], cur_len, quant=quant,
                                             window=_window(cfg, ltype), positions3=positions3, pages=pages)
        x = _ffn(_cross(x + mix, lp, ltype, cfg, quant, enc), lp, ltype, cfg, quant)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, _head(params))[:, 0], caches


def decode_verify(params, tokens: torch.Tensor, caches, cur_len: torch.Tensor, cfg: ArchConfig,
                  quant: QuantPolicy = BF16, *, pages: torch.Tensor):
    """Speculative verify step over the paged pool: ``tokens`` (B, T) -- the
    last committed token and the T - 1 drafts per slot -> (logits (B, T, V),
    caches).  Position t's logits predict the token at ``cur_len + t + 1``;
    each layer goes through ``attn.gqa_decode_verify``."""
    _gqa_stack_only(cfg, "speculative verify supports paged GQA attention stacks only")
    x = embed(tokens, params["embed"], cfg.cdtype)  # (B, T, d)
    for i, (ltype, lp) in enumerate(_layers(params, cfg)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        mix, caches[i] = attn.gqa_decode_verify(h, lp["mixer"], cfg, caches[i], cur_len, quant=quant,
                                                pages=pages)
        x = _ffn(x + mix, lp, ltype, cfg, quant)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, _head(params)), caches
