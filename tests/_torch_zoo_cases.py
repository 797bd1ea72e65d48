"""Shared setup of the zoo tests: reduced ``deepseek_v2_236b`` (MLA, MoE with
a shared expert and a dense first layer), ``qwen2_vl_7b`` (M-RoPE, the
vision stub's patch embeddings) and ``whisper_base`` (encoder-decoder,
cross-attention, GELU), each served by the JAX ``Engine`` and by the
port's from the same weights, in float32, with every norm gain and bias
drawn nonzero from a seed.

``run_case`` returns what the tests compare: the prefill's last logits, the
logits of every decode step (both engines fed the JAX engine's greedy
tokens), the caches right after prefill (packed GQA bytes, or MLA's latent
``c`` / ``kr``, or the recurrent ``h`` / ``conv`` states), and both
engines' ``generate`` output.  DeepSeek-V2 takes ``generate``'s bucketed
prefill; Qwen2-VL (with ``frontend_embeds``), whisper (with ``enc_frames``,
one prompt) and the recurrent archs (``RECURRENT_PROMPTS``, of one length)
the exact-length one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_engine_cases import _np, _policies
from repro.configs import get_config
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.models import transformer as jax_tf
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.policy import QuantPolicy
from repro_torch.serving.engine import Engine, ServeConfig

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30]]
WHISPER_PROMPTS = [[7, 8, 9, 10, 11, 12]]
# the recurrent archs take prompts of one length; 11 tokens outrun the
# reduced RecurrentGemma's window of 8, so the prefill and decode masks bite
RECURRENT_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30],
                     [40, 3, 41, 7, 42, 9, 43, 11, 44, 13, 45]]
MAX_LEN = 32
N_NEW = 6
LOGIT_TOL = 1e-5  # the engine tests' f32 tolerance (tests/test_torch_engine.py)
KV_NAMES = ("k_codes", "k_meta", "v_codes", "v_meta")
# the gains and biases init_params leaves zero, drawn nonzero here
GAINS = ("ln1", "ln2", "ln_x", "final_norm", "enc_norm", "q_norm", "k_norm", "kv_norm")
BIASES = ("bq", "bk", "bv", "up_b", "down_b")


def perturb(tree, seed: int = 1):
    """The numpy tree with every gain in ``GAINS`` and bias in ``BIASES``
    drawn from a seeded generator, in sorted key order."""
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


def configs(arch: str, **overrides):
    """(JAX config, port config): the reduced config in float32."""
    jcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32", **overrides)
    tcfg = dataclasses.replace(torch_get_config(arch).reduced(), compute_dtype="float32", **overrides)
    return jcfg, tcfg


def trees(jcfg, seed: int = 0):
    """(JAX params, the numpy tree, the port's params) from one JAX init."""
    tree = perturb(jax.tree_util.tree_map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)))
    return jax.tree_util.tree_map(jnp.asarray, tree), tree, params_from_numpy(tree, device="cpu")


def extras(cfg, batch: int, seed: int = 2):
    """(JAX extras, port extras): whisper's frames (batch, enc_frames, d), or
    the vision stub's embeddings of the 2 leading positions, else none."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_decoder:
        arr = rng.standard_normal((batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        return {"enc_frames": jnp.asarray(arr)}, {"enc_frames": torch.from_numpy(arr)}
    if cfg.frontend == "vision":
        arr = rng.standard_normal((batch, 2, cfg.d_model)).astype(np.float32)
        return {"frontend_embeds": jnp.asarray(arr)}, {"frontend_embeds": torch.from_numpy(arr)}
    return {}, {}


def policies(name: str):
    if name == "bf16":
        return JaxPolicy.bf16(), QuantPolicy.bf16()
    return _policies(name)


def engines(arch: str, policy: str):
    jcfg, tcfg = configs(arch)
    jparams, _, tparams = trees(jcfg)
    jpol, tpol = policies(policy)
    je = JaxEngine(jparams, jcfg, JaxServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW, quant=jpol))
    te = Engine(tparams, tcfg, ServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW, quant=tpol), device="cpu")
    return je, te


def _caches(jcache, tcache, n_layers):
    """(JAX, port) per-layer cache dicts as numpy: the JAX caches are stacked
    per layer group, the port's one per layer."""
    jl = [{n: np.asarray(g[n][i]) for n in g} for g in jcache for i in range(next(iter(g.values())).shape[0])]
    tl = [{n: (t.float() if t.is_floating_point() else t).numpy().copy() for n, t in c.items()} for c in tcache]
    assert len(jl) == len(tl) == n_layers
    return jl, tl


def prompts_of(cfg):
    if cfg.encoder_decoder:
        return WHISPER_PROMPTS
    return RECURRENT_PROMPTS if cfg.ssm or cfg.block_pattern else PROMPTS


def run_case(arch: str, policy: str):
    torch.set_num_threads(2)
    je, te = engines(arch, policy)
    prompts = prompts_of(te.cfg)
    jx, tx = extras(te.cfg, len(prompts))
    toks, lens, bucketed = te._prefill_input(prompts, tx)
    tlast, tcache, tenc = te._prefill_batch(toks, lens, tx)
    toks = toks.astype(np.int32)
    if bucketed:
        jlast, jcache = je._bucketed_prefill(toks, lens, max_len=MAX_LEN, qdq_kv=je.kv_quant)
        jcache = je._quantize_caches(jcache) if je.kv_quant else jcache
        jenc = None
    else:
        jlast, jcache, jenc = je._prefill(jnp.asarray(toks), jnp.asarray(lens), jx)
    caches = _caches(jcache, tcache, te.cfg.num_layers)

    jax_logits, port_logits = [_np(jlast)], [_np(tlast)]
    tok = np.asarray(jnp.argmax(jlast, axis=-1)).astype(np.int32)
    cur = lens.copy()
    for _ in range(N_NEW - 1):
        jlog, jcache = je._decode_jit(je.params, jnp.asarray(tok), jcache, jnp.asarray(cur), jenc)
        tlog, tcache = te._decode_step(torch.as_tensor(tok).long(), tcache, torch.as_tensor(cur), tenc)
        jax_logits.append(_np(jlog))
        port_logits.append(_np(tlog))
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        cur = cur + 1
    return {"jax_logits": jax_logits, "port_logits": port_logits, "caches": caches,
            "jax_tokens": je.generate(prompts, extras=jx, max_new_tokens=N_NEW),
            "port_tokens": te.generate(prompts, extras=tx, max_new_tokens=N_NEW),
            "port_tokens_plain": te.generate(prompts, max_new_tokens=N_NEW) if te.cfg.frontend == "vision" else None,
            "cfg": te.cfg}


# the comparisons, imported by each test file beside its own ``case`` fixture
def test_prefill_last_logits_match(case):
    np.testing.assert_allclose(case["port_logits"][0], case["jax_logits"][0], rtol=0, atol=LOGIT_TOL)


def test_decode_step_logits_match(case):
    for step, (got, want) in enumerate(zip(case["port_logits"][1:], case["jax_logits"][1:])):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL, err_msg=f"decode step {step}")


def test_generate_tokens_match(case):
    assert case["port_tokens"] == case["jax_tokens"]
