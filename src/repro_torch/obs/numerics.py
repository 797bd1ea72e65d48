"""Numerics observability: the per-layer quantization audit (PyTorch port of
``repro.obs.numerics``).

Given a model's raw params and its ``QuantPolicy`` (plus, for packed mode,
the wire-format tree ``pack_model_weights`` produced), ``audit_model`` emits
a per-layer report:

* **error vs reference** -- SQNR (dB), MSE and max-abs-err of the
  dequantized wire bytes against the reference weights;
* **FP4 code usage** -- a 16-bin histogram of the raw wire nibbles, and the
  SV-remap telemetry the paper's central claim rests on: how often the
  redundant ``-0`` code (``FP4_NEG_ZERO_CODE``) fires, per block and per
  element, split by which SV pair the metadata selected
  (``unpack_scale_meta_fields``);
* **scale-code distribution** -- min/max E3M3 scale codes with clipping
  (grid-max) and underflow (grid-min) block counts;
* **packed-vs-fakequant drift** -- ``PackedRazerWeight.dequantize()``
  against the registry fakequant path (``TensorSpec.quantize``): exactly 0
  for razer, on the CPU and on the card.

The report is the JAX package's, entry for entry: one entry per reference
path.  The port keeps a layer group as a list of L per-layer dicts where
the reference stacks each leaf along a leading L, so the walk gathers the L
per-layer tensors (or containers) of one path into one entry: shape
``[L, ...]``, ``entries`` L (L x E for an expert bank), histograms summed,
SQNR pooled from summed float64 squares, max-abs and drift maxed.  The
statistics are computed on the tensors' device, one (K, N) entry at a time,
in float64 there; only scalars and the 16- and 4-bin histograms reach the
host, so a full-width model audits on the card without a host copy of it.

Sibling formats self-report through the registry's ``audit_fn`` hook;
formats without one get ``generic_audit``.  ``install_numerics_metrics``
exports per-layer gauges under a cardinality guard plus model-level
rollups, and ``audit_model(tracer=...)`` drops one ``quant_audit`` instant
per audited layer onto the trace timeline.  ``KVAuditor`` extends the audit
to live serving: a sampling hook on ``KVPagePool.write_prefill`` records
the KV quantization error per page, off by default and read-only, so serve
outputs are bit-identical with it on or off.  The report has a versioned
JSON schema (``REPORT_SCHEMA`` / ``validate_report``); the CLI is
``python -m repro_torch.launch.quant_report``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core import registry
from repro_torch.core.formats import FP4_NEG_ZERO_CODE, positive_format_values
from repro_torch.core.packing import PackedRazerWeight, PackedStackedTensor, unpack_scale_meta_fields
from repro_torch.core.policy import QuantPolicy, TensorSpec

__all__ = [
    "REPORT_SCHEMA",
    "REPORT_SCHEMA_VERSION",
    "audit_model",
    "audit_layer",
    "razer_audit",
    "generic_audit",
    "install_numerics_metrics",
    "validate_report",
    "KVAuditor",
]

REPORT_SCHEMA_VERSION = "razer-quant-report/v1"

# pack_model_weights packs weights >= this many elements; the audit mirrors
# the eligibility rule so its layer set matches what actually packs
_MIN_AUDIT = 16 * 16


def _round(x) -> Optional[float]:
    """9-significant-digit float for byte-stable golden reports (None for
    NaN/inf -- JSON has no spelling for them)."""
    if x is None:
        return None
    f = float(x)
    if math.isnan(f) or math.isinf(f):
        return None
    return float(f"{f:.9g}")


def _sqnr_db(sum_sq_ref: float, sum_sq_err: float) -> Optional[float]:
    """10*log10(signal/noise); None when the error is exactly zero (infinite
    SQNR) or there is no signal."""
    if sum_sq_err <= 0.0 or sum_sq_ref <= 0.0:
        return None
    return 10.0 * math.log10(sum_sq_ref / sum_sq_err)


def _members(x) -> list:
    """The per-layer members of a gathered leaf (a list), or [x]."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _shape(x) -> List[int]:
    """The reference's (stacked) shape of a leaf or a gathered leaf."""
    if isinstance(x, (list, tuple)):
        return [len(x)] + [int(s) for s in x[0].shape]
    return [int(s) for s in x.shape]


def _numel(x) -> int:
    return math.prod(_shape(x))


def _stack(x, dtype=torch.float32) -> torch.Tensor:
    """A gathered leaf as the reference's stacked tensor (one leaf as is)."""
    if isinstance(x, (list, tuple)):
        return torch.stack([m.to(dtype) for m in x])
    return x.to(dtype)


# ---------------------------------------------------------------------------
# razer wire-byte audit (PackedRazerWeight / PackedStackedTensor)
# ---------------------------------------------------------------------------
def _wire_entries(obj, ref):
    """(PackedRazerWeight, reference (K, N) or None) for every (K, N) entry
    of a container or of a gathered list of them, layer-major (a bank's
    experts within its layer), as the reference flattens a stacked leaf."""
    refs = _members(ref) if ref is not None else None
    for i, c in enumerate(_members(obj)):
        r = refs[i] if refs is not None else None
        if isinstance(c, PackedStackedTensor):
            for e in range(c.shape[0]):
                yield c[e], (r[e] if r is not None else None)
        else:
            yield c, r


def razer_audit(obj, ref, spec: TensorSpec, axis: int = 0) -> Dict[str, Any]:
    """The razer ``audit_fn``: the wire-byte audit for packed containers (or
    a gathered list of one path's per-layer containers), the generic
    BlockQuantized audit for fakequant-mode raw weights.

    ``ref`` is the reference weight with the container's logical shape (a
    list of them for a gathered leaf), or None (packed params without the
    source checkpoint: code/scale telemetry only, no error or drift)."""
    first = _members(obj)[0]
    if not isinstance(first, (PackedRazerWeight, PackedStackedTensor)):
        return generic_audit(obj, ref, spec, axis=axis)

    dev = first.codes.device
    top_code = positive_format_values("e3m3").size - 1
    zero_l = lambda n=1: torch.zeros(n, dtype=torch.long, device=dev)  # noqa: E731
    zero_d = lambda: torch.zeros((), dtype=torch.float64, device=dev)  # noqa: E731
    code_hist, select_hist = zero_l(16), zero_l(4)
    sv_blocks, elements, clipped, underflow = zero_l(), zero_l(), zero_l(), zero_l()
    min_code = max_code = None
    sum_sq_ref, sum_sq_err, max_abs, drift = zero_d(), zero_d(), zero_d(), zero_d()
    m = n_blocks = wire_bytes = values = 0
    for pw, r in _wire_entries(obj, ref):
        k, n = pw.shape
        m += 1
        values += k * n
        # the wire nibbles: two codes a byte along K, the low nibble the even
        # element; a 16-element block is 8 consecutive bytes along K
        lo, hi = pw.codes & 0xF, pw.codes >> 4
        code_hist += torch.bincount(lo.reshape(-1).long(), minlength=16)
        code_hist += torch.bincount(hi.reshape(-1).long(), minlength=16)
        hit = (lo == FP4_NEG_ZERO_CODE) | (hi == FP4_NEG_ZERO_CODE)  # fp4_encode never emits -0: a hit IS a remap
        elements += (lo == FP4_NEG_ZERO_CODE).sum() + (hi == FP4_NEG_ZERO_CODE).sum()
        block_hit = hit.reshape(k // 16, 8, n).any(dim=1)  # (K/16, N), scale_meta's layout
        code, sel, sign = unpack_scale_meta_fields(pw.scale_meta, weight=True)
        sel_idx = (sel.long() << 1) | sign.long()  # (+m0, -m0, +m1, -m1) order
        # blocks without a hit count in a fifth bin, dropped (no host sync)
        select_hist += torch.bincount(torch.where(block_hit, sel_idx, 4).reshape(-1), minlength=5)[:4]
        sv_blocks += block_hit.sum()
        lo_c, hi_c = code.min(), code.max()
        min_code = lo_c if min_code is None else torch.minimum(min_code, lo_c)
        max_code = hi_c if max_code is None else torch.maximum(max_code, hi_c)
        clipped += (code == top_code).sum()
        underflow += (code == 0).sum()
        n_blocks += pw.scale_meta.numel()
        wire_bytes += pw.codes.numel() + pw.scale_meta.numel() + 4  # + the f32 tensor scale
        if r is None:
            continue
        wq = pw.dequantize()  # the wire decode
        # the registry invariant: the fakequant path (razer_quantize through
        # the registry dispatch) and the wire decode are the SAME numbers
        fq = spec.quantize(r.to(torch.float32), axis=0).dequantize()
        drift = torch.maximum(drift, (wq - fq).abs().amax().double())
        r64 = r.double()
        err = wq.double() - r64
        sum_sq_ref += (r64 * r64).sum()
        sum_sq_err += (err * err).sum()
        max_abs = torch.maximum(max_abs, err.abs().amax())
        del wq, fq, r64, err

    blocks, hits = int(sv_blocks), int(elements)
    stats: Dict[str, Any] = {
        "entries": m,
        "n_blocks": n_blocks,
        "wire_bytes": wire_bytes,
        "code_hist": [int(c) for c in code_hist.tolist()],
        "sv": {
            "blocks": blocks,
            "block_rate": _round(blocks / n_blocks),
            "elements": hits,
            "element_rate": _round(hits / values),
            "select_hist": [int(c) for c in select_hist.tolist()],
            "magnitudes": [float(v) for v in first.sv_magnitudes],
        },
        "scale": {
            "min_code": int(min_code),
            "max_code": int(max_code),
            "clipped_blocks": int(clipped),
            "underflow_blocks": int(underflow),
        },
    }
    if ref is None:
        return stats
    ss_ref, ss_err = float(sum_sq_ref), float(sum_sq_err)
    stats.update(
        sqnr_db=_round(_sqnr_db(ss_ref, ss_err)),
        mse=_round(ss_err / values),
        max_abs_err=_round(float(max_abs)),
        drift_max_abs=_round(float(drift)),
    )
    return stats


# ---------------------------------------------------------------------------
# generic BlockQuantized-protocol audit (every other registered format)
# ---------------------------------------------------------------------------
def generic_audit(w, ref, spec: TensorSpec, axis: int = 0) -> Dict[str, Any]:
    """Audit any format through its registry ``quantize`` fn alone.

    The value histogram comes from the quantized grid values themselves,
    the drift check asserts the registry invariant that two dispatches of
    the same input produce identical numbers, and SV telemetry appears when
    the format's container carries an ``sv_index`` (razer fakequant does;
    nvfp4 does not).  A gathered leaf is stacked first: the reference
    quantizes the stacked leaf as one tensor, under one tensor scale."""
    x = _stack(w)
    bq = spec.quantize(x, axis=axis)
    deq = bq.dequantize()
    # registry determinism invariant: re-dispatching the same tensor through
    # the same spec must reproduce the dequantized numbers exactly
    deq2 = spec.quantize(x, axis=axis).dequantize()
    drift = float((deq - deq2).abs().amax())
    del deq2

    q = bq.q.double()
    values, counts = torch.unique(q, sorted=True, return_counts=True)
    scale = bq.block_scale.double()
    stats: Dict[str, Any] = {
        "entries": 1,
        "n_blocks": q.numel() // q.shape[-1],
        "value_hist": {_fmt_value(v): int(c) for v, c in zip(values.tolist(), counts.tolist())},
        "scale": {
            "min": _round(float(scale.min())),
            "max": _round(float(scale.max())),
            "underflow_blocks": int((scale == 0.0).sum()),
        },
        "drift_max_abs": _round(drift),
    }
    if getattr(bq, "sv_index", None) is not None:
        active = bq.sv_index >= 0
        hits = (q == bq.sv.double()[..., None]) & active[..., None]
        n_active, n_hits = int(active.sum()), int(hits.sum())
        stats["sv"] = {
            "blocks": n_active,
            "block_rate": _round(n_active / active.numel()),
            "elements": n_hits,
            "element_rate": _round(n_hits / hits.numel()),
        }
    if ref is not None:
        ref64 = _stack(ref, torch.float64)
        err = deq.double().reshape(ref64.shape) - ref64
        ss_ref, ss_err = float((ref64 * ref64).sum()), float((err * err).sum())
        stats.update(
            sqnr_db=_round(_sqnr_db(ss_ref, ss_err)),
            mse=_round(ss_err / ref64.numel()),
            max_abs_err=_round(float(err.abs().amax())),
        )
    return stats


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


# ---------------------------------------------------------------------------
# per-layer + whole-model audit
# ---------------------------------------------------------------------------
def audit_layer(path: str, raw_leaf, leaf, spec: TensorSpec) -> Optional[Dict[str, Any]]:
    """One report entry for a resolved layer (``raw_leaf`` / ``leaf`` a
    tensor or container, or a gathered list of one path's per-layer ones),
    or None when the layer is structurally ineligible and stayed dense
    (the ``pack_model_weights`` eligibility rule, on the reference's
    stacked shape).  Dispatches to the format's registered ``audit_fn``
    (``generic_audit`` when it has none)."""
    audit_fn = spec.entry.audit_fn or generic_audit
    first = _members(leaf)[0]
    shape = _shape(raw_leaf)
    if registry.packed_entry(first) or registry.grouped_entry(first):
        stats = audit_fn(leaf, raw_leaf, spec)
        mode, container_name = "packed", type(first).__name__
    else:
        axis = len(shape) - 2
        if len(shape) < 2 or math.prod(shape) < _MIN_AUDIT or shape[axis] % spec.effective_block_size:
            return None
        if spec.mode == "packed":
            # resolved packed but the serving tree kept it dense
            return None
        stats = audit_fn(raw_leaf, raw_leaf, spec, axis=axis)
        mode, container_name = "fakequant", None
    out: Dict[str, Any] = {
        "path": path,
        "format": spec.format,
        "mode": mode,
        "container": container_name,
        "shape": shape,
        "params": math.prod(shape),
    }
    out.update(stats)
    return out


def _gathered(layers_raw: Sequence[dict], layers_pk: Sequence[dict], path: str):
    """(path, [raw leaf per layer], [served leaf per layer]) for every leaf
    path of a ``layers_<g>`` list, in the first layer's key order: the
    reference's scan-stacked group walked leaf by leaf."""

    def get(tree, keys):
        for k in keys:
            tree = tree[k]
        return tree

    def rec(node, keys, p):
        if isinstance(node, dict):
            for k in node:
                yield from rec(node[k], keys + (k,), f"{p}/{k}")
        else:
            yield p, [get(lr, keys) for lr in layers_raw], [get(lp, keys) for lp in layers_pk]

    yield from rec(layers_raw[0], (), path)


def audit_model(params, policy: QuantPolicy, *, packed=None, model: Optional[str] = None, metrics=None,
                tracer=None, max_layer_series: int = 256, kv_audit=None) -> Dict[str, Any]:
    """Audit a whole param tree under ``policy`` -> the report dict.

    ``packed`` is the wire-format tree ``pack_model_weights`` produced; when
    omitted, the packing runs here (same walk, same eligibility).
    ``metrics`` / ``tracer`` are optional sinks: per-layer gauges and
    rollups land in the registry (``install_numerics_metrics``, with
    ``max_layer_series`` as the cardinality guard) and one ``quant_audit``
    instant per layer lands on the trace timeline.  ``kv_audit`` merges a
    ``KVAuditor`` snapshot into the report's ``kv`` section."""
    if packed is None:
        from repro_torch.serving.engine import pack_model_weights

        packed = pack_model_weights(params, None, policy)

    layers: List[Dict[str, Any]] = []
    counts = {"dense": 0, "params_total": 0, "params_quantized": 0}

    def leaf(raw, pk, path):
        counts["params_total"] += _numel(raw)
        spec = policy.resolve(path)
        entry = audit_layer(path, raw, pk, spec) if spec is not None else None
        if entry is None:
            counts["dense"] += 1
            return
        counts["params_quantized"] += entry["params"]
        layers.append(entry)

    def walk(raw, pk, path=""):
        if isinstance(raw, dict):
            for key in raw:
                walk(raw[key], pk[key], f"{path}/{key}" if path else str(key))
        elif isinstance(raw, list):
            for p, raws, pks in _gathered(raw, pk, path):
                leaf(raws, pks, p)
        else:
            leaf(raw, pk, path)

    walk(params, packed)

    sqnrs = [(l["sqnr_db"], l["path"]) for l in layers if l.get("sqnr_db") is not None]
    drifts = [l["drift_max_abs"] for l in layers if l.get("drift_max_abs") is not None]
    sv_blocks = sum(l["sv"]["blocks"] for l in layers if l.get("sv"))
    blocks_total = sum(l["n_blocks"] for l in layers)
    rollups: Dict[str, Any] = {
        "layers_audited": len(layers),
        "layers_dense": counts["dense"],
        "params_total": counts["params_total"],
        "params_quantized": counts["params_quantized"],
        "wire_bytes": sum(l.get("wire_bytes", 0) for l in layers),
        "blocks_total": blocks_total,
        "sv_blocks": sv_blocks,
        "sv_block_rate": _round(sv_blocks / blocks_total) if blocks_total else None,
        "clipped_blocks": sum(l["scale"].get("clipped_blocks", 0) for l in layers if l.get("scale")),
        "underflow_blocks": sum(l["scale"].get("underflow_blocks", 0) for l in layers if l.get("scale")),
        "min_sqnr_db": _round(min(sqnrs)[0]) if sqnrs else None,
        "mean_sqnr_db": _round(sum(s for s, _ in sqnrs) / len(sqnrs)) if sqnrs else None,
        "worst_layer": min(sqnrs)[1] if sqnrs else None,
        "max_drift": _round(max(drifts)) if drifts else None,
    }
    report: Dict[str, Any] = {
        "schema": REPORT_SCHEMA_VERSION,
        "model": model,
        "policy": {
            "weight_format": policy.weight.format,
            "mode": policy.mode,
            "block_size": policy.weight.block_size,
            "scale_fmt": policy.weight.scale_fmt,
        },
        "layers": layers,
        "rollups": rollups,
        "kv": kv_audit.snapshot() if kv_audit is not None else None,
    }
    if tracer is not None and tracer.enabled:
        for l in layers:
            tracer.instant("quant_audit", layer=l["path"], format=l["format"], sqnr_db=l.get("sqnr_db"),
                           sv_block_rate=(l.get("sv") or {}).get("block_rate"), drift=l.get("drift_max_abs"))
    if metrics is not None:
        install_numerics_metrics(metrics, report, max_layers=max_layer_series)
    return report


# ---------------------------------------------------------------------------
# metrics export
# ---------------------------------------------------------------------------
def install_numerics_metrics(registry_, report: Dict[str, Any], *, max_layers: int = 256) -> None:
    """Export a report into a ``MetricsRegistry``: per-layer gauges capped at
    ``max_layers`` series (the cardinality guard: overflow layers are
    counted, not exported) plus model-level rollups."""
    g_sqnr = registry_.gauge("quant_layer_sqnr_db", "Per-layer SQNR of quantized vs bf16 weights (dB)",
                             labels=("layer",), max_series=max_layers)
    g_sv = registry_.gauge("quant_layer_sv_block_rate", "Per-layer fraction of quant blocks whose SV remap fired",
                           labels=("layer",), max_series=max_layers)
    g_drift = registry_.gauge("quant_layer_drift", "Per-layer packed-vs-fakequant max abs drift",
                              labels=("layer",), max_series=max_layers)
    dropped = 0
    for l in report["layers"]:
        try:
            if l.get("sqnr_db") is not None:
                g_sqnr.set(l["sqnr_db"], layer=l["path"])
            if l.get("sv"):
                g_sv.set(l["sv"]["block_rate"], layer=l["path"])
            if l.get("drift_max_abs") is not None:
                g_drift.set(l["drift_max_abs"], layer=l["path"])
        except ValueError:
            dropped += 1
    registry_.gauge("quant_layers_dropped", "Audited layers past the per-layer gauge cardinality guard").set(dropped)
    roll = report["rollups"]
    sq = registry_.gauge("quant_model_sqnr_db", "Model-level SQNR rollup (dB)", labels=("stat",))
    if roll["min_sqnr_db"] is not None:
        sq.set(roll["min_sqnr_db"], stat="min")
        sq.set(roll["mean_sqnr_db"], stat="mean")
    if roll["sv_block_rate"] is not None:
        registry_.gauge("quant_model_sv_block_rate", "Whole-model SV-remap block rate").set(roll["sv_block_rate"])
    if roll["max_drift"] is not None:
        registry_.gauge("quant_model_drift_max", "Worst packed-vs-fakequant drift").set(roll["max_drift"])
    registry_.gauge("quant_model_wire_bytes", "Packed wire bytes across audited layers").set(roll["wire_bytes"])
    layers_g = registry_.gauge("quant_model_layers", "Audited vs dense layer counts", labels=("state",))
    layers_g.set(roll["layers_audited"], state="audited")
    layers_g.set(roll["layers_dense"], state="dense")


# ---------------------------------------------------------------------------
# live-serving KV sampling hook (KVPagePool.write_prefill)
# ---------------------------------------------------------------------------
class KVAuditor:
    """Samples KV quantization error at ``KVPagePool.write_prefill`` time.

    Off by default: the pool's hook slot is ``None`` and the write path pays
    one ``is not None`` check.  Attached (``pool.set_kv_audit(auditor)`` /
    ``Engine.serve(kv_audit=...)``) it re-quantizes the prefill's K/V
    out-of-band with ``kv_quantize`` / ``kv_dequantize`` and records per-page
    error; it never writes the pool, so serve outputs are bit-identical with
    the hook on or off.

    ``sample_every`` thins the hook to every Nth prefill (a deterministic
    counter); ``max_pages`` bounds the per-page record list (aggregates keep
    accumulating past it); ``group`` picks the audited layer group (0: the
    first).  The per-page sums are segment sums over page ids on the
    caches' device; the small per-page arrays reach the host once per
    sampled prefill."""

    def __init__(self, sample_every: int = 1, max_pages: int = 256, group: int = 0):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = int(sample_every)
        self.max_pages = int(max_pages)
        self.group = int(group)
        self.calls = 0
        self.pages_sampled = 0
        self.tokens_sampled = 0
        self.pages_dropped = 0
        self.pages: List[Dict[str, Any]] = []
        self._sum_sq_ref = 0.0
        self._sum_sq_err = 0.0
        self._max_abs_err = 0.0

    # -- the hook ------------------------------------------------------------
    def observe_prefill(self, seq_id: int, caches, length: int, start: int, page_size: int,
                        group_sizes: Optional[Sequence[int]] = None) -> None:
        """Record per-page KV quantization error for one prefill write.

        ``caches`` is the per-layer list ``write_prefill`` received
        (``{"k": (1, S, KVH, hd), "v": ...}``, read-only here) and
        ``group_sizes`` the layer count of each layer group (default: one
        group); positions ``[start, length)`` are valid, and cache index
        ``j`` holds token ``start + j`` on logical page ``(start + j) //
        page_size``."""
        self.calls += 1
        if (self.calls - 1) % self.sample_every:
            return
        from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

        sizes = list(group_sizes) if group_sizes is not None else [len(caches)]
        first = sum(sizes[:self.group])
        group = caches[first:first + sizes[self.group]]
        kv = torch.stack([torch.stack([c["k"][0] for c in group]),
                          torch.stack([c["v"][0] for c in group])])  # (2, count, S, KVH, hd)
        n_valid = max(0, min(kv.shape[2], length - start))
        if n_valid == 0:
            return
        kv = kv[:, :, :n_valid]
        codes, meta = kv_quantize(kv)
        err = (kv_dequantize(codes, meta, kv.shape[-1]) - kv.to(torch.float32)).double()
        ref = kv.double()
        dims = (0, 1, 3, 4)
        pos = start + torch.arange(n_valid, device=kv.device)
        first_page = start // page_size
        seg = pos // page_size - first_page  # page-local index of each valid position
        n_pages = int((start + n_valid - 1) // page_size) - first_page + 1
        zeros = torch.zeros(n_pages, dtype=torch.float64, device=kv.device)
        sums = torch.stack([
            zeros.index_add(0, seg, (ref * ref).sum(dim=dims)),
            zeros.index_add(0, seg, (err * err).sum(dim=dims)),
            zeros.scatter_reduce(0, seg, err.abs().amax(dim=dims), reduce="amax"),
            zeros.index_add(0, seg, torch.ones(n_valid, dtype=torch.float64, device=kv.device)),
        ]).cpu().tolist()
        # the valid positions are contiguous, so every page in the range holds some
        for i, (sum_sq_ref, sum_sq_err, max_abs, tokens) in enumerate(zip(*sums)):
            self.pages_sampled += 1
            self.tokens_sampled += int(tokens)
            self._sum_sq_ref += sum_sq_ref
            self._sum_sq_err += sum_sq_err
            self._max_abs_err = max(self._max_abs_err, max_abs)
            rec = {
                "seq": int(seq_id),
                "page": first_page + i,
                "tokens": int(tokens),
                "sqnr_db": _round(_sqnr_db(sum_sq_ref, sum_sq_err)),
                "max_abs_err": _round(max_abs),
            }
            if len(self.pages) < self.max_pages:
                self.pages.append(rec)
            else:
                self.pages_dropped += 1

    # -- results -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able aggregate + the bounded per-page records (the report's
        ``kv`` section)."""
        return {
            "prefills_seen": self.calls,
            "sample_every": self.sample_every,
            "pages_sampled": self.pages_sampled,
            "tokens_sampled": self.tokens_sampled,
            "sqnr_db": _round(_sqnr_db(self._sum_sq_ref, self._sum_sq_err)),
            "max_abs_err": _round(self._max_abs_err),
            "pages": list(self.pages),
            "pages_dropped": self.pages_dropped,
        }

    def install(self, registry_, stage: str = "engine") -> None:
        """Function-backed gauges into a ``MetricsRegistry`` (read at
        collection time; the hook itself never touches the registry)."""
        pages = registry_.gauge("kv_audit_pages", "KV pages sampled for quantization error", labels=("stage",))
        pages.set_function(lambda: self.pages_sampled, stage=stage)
        sqnr = registry_.gauge("kv_audit_sqnr_db", "Aggregate KV quantization SQNR (dB)", labels=("stage",))
        sqnr.set_function(lambda: _sqnr_db(self._sum_sq_ref, self._sum_sq_err) or 0.0, stage=stage)
        mx = registry_.gauge("kv_audit_max_abs_err", "Worst sampled KV quantization error", labels=("stage",))
        mx.set_function(lambda: self._max_abs_err, stage=stage)


# ---------------------------------------------------------------------------
# report JSON schema + minimal validator (no external jsonschema dependency)
# ---------------------------------------------------------------------------
REPORT_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "required": ["schema", "model", "policy", "layers", "rollups", "kv"],
    "properties": {
        "schema": {"type": "string", "enum": [REPORT_SCHEMA_VERSION]},
        "model": {"type": ["string", "null"]},
        "policy": {
            "type": "object",
            "required": ["weight_format", "mode", "block_size"],
            "properties": {
                "weight_format": {"type": ["string", "null"]},
                "mode": {"type": "string", "enum": ["bf16", "fakequant", "packed"]},
                "block_size": {"type": "integer"},
            },
        },
        "layers": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["path", "format", "mode", "shape", "params", "n_blocks"],
                "properties": {
                    "path": {"type": "string"},
                    "format": {"type": "string"},
                    "mode": {"type": "string", "enum": ["packed", "fakequant"]},
                    "shape": {"type": "array", "items": {"type": "integer"}},
                    "params": {"type": "integer"},
                    "entries": {"type": "integer"},
                    "n_blocks": {"type": "integer"},
                    "wire_bytes": {"type": "integer"},
                    "code_hist": {"type": "array", "items": {"type": "integer"}},
                    "sqnr_db": {"type": ["number", "null"]},
                    "mse": {"type": ["number", "null"]},
                    "max_abs_err": {"type": ["number", "null"]},
                    "drift_max_abs": {"type": ["number", "null"]},
                    "sv": {"type": ["object", "null"]},
                    "scale": {"type": ["object", "null"]},
                },
            },
        },
        "rollups": {
            "type": "object",
            "required": ["layers_audited", "layers_dense", "params_total", "params_quantized", "blocks_total",
                         "sv_block_rate", "min_sqnr_db", "max_drift"],
        },
        "kv": {"type": ["object", "null"]},
    },
}

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "integer": int,
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value, t: str) -> bool:
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, _TYPES[t])


def _validate(value, schema: Dict[str, Any], where: str, out: List[str]) -> None:
    types = schema.get("type")
    if types is not None:
        allowed = types if isinstance(types, list) else [types]
        if not any(_type_ok(value, t) for t in allowed):
            out.append(f"{where}: expected {'|'.join(allowed)}, got {type(value).__name__}")
            return
    if "enum" in schema and value not in schema["enum"]:
        out.append(f"{where}: {value!r} not in {schema['enum']}")
    if isinstance(value, dict):
        for req in schema.get("required", ()):
            if req not in value:
                out.append(f"{where}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in value:
                _validate(value[key], sub, f"{where}.{key}", out)
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            _validate(item, schema["items"], f"{where}[{i}]", out)


def validate_report(doc: Any) -> List[str]:
    """Violations of ``REPORT_SCHEMA`` (empty list = valid)."""
    out: List[str] = []
    _validate(doc, REPORT_SCHEMA, "$", out)
    return out
