"""Shared setup for the engine tests: one reduced config (``llama3_2_3b`` by
default) served by the JAX ``Engine`` and by the port's ``Engine`` from the
same weights.

``run_case`` returns what the tests compare: the prefill's last logits, the
logits of every decode step (both engines fed the JAX engine's greedy tokens,
so one early difference cannot steer the rest), the packed KV-cache bytes
right after prefill, and both engines' ``generate`` output.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.core.policy import TensorSpec as JaxSpec
from repro.models import transformer as jax_tf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.policy import QuantPolicy, TensorSpec
from repro_torch.serving.engine import Engine, ServeConfig

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30]]
MAX_LEN = 32
N_NEW = 6
KV_NAMES = ("k_codes", "k_meta", "v_codes", "v_meta")


def _policies(name):
    jp, tp = JaxPolicy.packed(kv_quant=True), QuantPolicy.packed(kv_quant=True)
    if name == "w4a4_kv":
        jp = JaxPolicy(weight=jp.weight, act=JaxSpec.act("razer"), kv=jp.kv, rules=jp.rules)
        tp = QuantPolicy(weight=tp.weight, act=TensorSpec.act("razer"), kv=tp.kv, rules=tp.rules)
    return jp, tp


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


BIASES = ("bq", "bk", "bv")
GAINS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def perturb(tree, seed: int):
    """A numpy parameter tree with every qkv bias and every RMSNorm gain
    (the layer norms, the final norm and the qk-norm) drawn nonzero from a
    seeded generator: ``init_params`` leaves them all zero, which would not
    exercise the bias add or the gain."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for key in sorted(t):
            v = t[key]
            if isinstance(v, dict):
                out[key] = walk(v)
            elif key in BIASES:
                out[key] = rng.normal(0.0, 0.5, v.shape).astype(v.dtype)
            elif key in GAINS:
                out[key] = rng.normal(0.0, 0.2, v.shape).astype(v.dtype)
            else:
                out[key] = v
        return out

    return walk(tree)


def run_case(policy: str, kv_heads, dtype: str, arch: str = "llama3_2_3b", perturb_seed=None, **overrides):
    """``kv_heads`` None keeps the reduced config's; ``perturb_seed`` draws
    the biases and norm gains nonzero (``perturb``) in both packages."""
    torch.set_num_threads(2)
    if kv_heads is not None:
        overrides["num_kv_heads"] = kv_heads
    jcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype, **overrides)
    tcfg = dataclasses.replace(torch_get_config(arch).reduced(), compute_dtype=dtype, **overrides)
    jparams = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    if perturb_seed is not None:
        tree = perturb(tree, perturb_seed)
        jparams = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    jpol, tpol = _policies(policy)
    je = JaxEngine(jparams, jcfg, JaxServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW, quant=jpol))
    te = Engine(tparams, tcfg, ServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW, quant=tpol),
                device="cpu")
    return compare_engines(je, te)


def compare_engines(je, te):
    """The comparison of ``run_case`` on two engines already built on the
    same weights; ``max_len`` is the engines' own."""
    max_len = te.scfg.max_len
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    toks = np.zeros((len(PROMPTS), te._bucket(int(lens.max()), max_len)), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, : len(p)] = p
    jlast, jcache = je._bucketed_prefill(toks, lens, max_len=max_len, qdq_kv=True)
    jcache = je._quantize_caches(jcache)
    tlast, tcache = te._bucketed_prefill(toks, lens, max_len=max_len, qdq_kv=True)
    tcache = te._quantize_caches(tcache)
    # the JAX caches are stacked per layer group, the port's one per layer
    jlayers = [{n: group[n][i] for n in KV_NAMES} for group in jcache for i in range(group["k_codes"].shape[0])]
    kv = [(np.asarray(jlayers[li][n]), tcache[li][n].numpy().copy())
          for li in range(te.cfg.num_layers) for n in KV_NAMES]

    jax_logits, port_logits = [_np(jlast)], [_np(tlast)]
    tok = np.asarray(jax.numpy.argmax(jlast, axis=-1)).astype(np.int32)
    cur = lens.copy()
    for _ in range(N_NEW - 1):
        jlog, jcache = je._decode_jit(je.params, jax.numpy.asarray(tok), jcache,
                                      jax.numpy.asarray(cur), None)
        tlog, tcache = te._decode_step(torch.as_tensor(tok).long(), tcache, torch.as_tensor(cur))
        jax_logits.append(_np(jlog))
        port_logits.append(_np(tlog))
        tok = np.asarray(jax.numpy.argmax(jlog, axis=-1)).astype(np.int32)
        cur = cur + 1
    return {
        "jax_logits": jax_logits,
        "port_logits": port_logits,
        "kv": kv,
        "jax_tokens": je.generate(PROMPTS, max_new_tokens=N_NEW),
        "port_tokens": te.generate(PROMPTS, max_new_tokens=N_NEW),
    }


def top2_margin(logits: np.ndarray) -> np.ndarray:
    """Per row: the largest logit minus the second largest."""
    s = np.sort(logits, axis=-1)
    return s[:, -1] - s[:, -2]


def check_greedy(case, tol: float) -> None:
    """Greedy tokens agree wherever the JAX top-2 margin exceeds ``tol``.

    Walks each sequence's new tokens in order; at the first difference the
    JAX engine's margin at that step must be <= tol (a near-tie the two
    packages may break differently), and later tokens are not compared (they
    follow different prefixes)."""
    for i, p in enumerate(PROMPTS):
        jt, pt = case["jax_tokens"][i][len(p):], case["port_tokens"][i][len(p):]
        assert len(jt) == len(pt) == N_NEW
        for step, (a, b) in enumerate(zip(jt, pt)):
            if a != b:
                margin = top2_margin(case["jax_logits"][step])[i]
                assert margin <= tol, (i, step, a, b, margin)
                break


def kv_mismatch_fraction(case, first_layer_only: bool = False) -> float:
    pairs = case["kv"][: len(KV_NAMES)] if first_layer_only else case["kv"]
    bad = sum(int((a != b).sum()) for a, b in pairs)
    return bad / sum(a.size for a, _ in pairs)
