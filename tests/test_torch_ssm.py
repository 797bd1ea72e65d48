"""The state-space blocks in the port (``repro_torch.models.ssm``) against the
JAX functions of the same name, on the JAX package's weights and the same
seeded numpy inputs, in float32: the causal conv and its one-step form,
the projection split, the chunked SSD at sequence lengths its chunk
divides and does not (the reference's halving), the whole Mamba-2 block
and its decode step, the RG-LRU gates, the associative scan (the
reference's odd/even recursion, checked against ``jax.lax.associative_scan``
at even and odd lengths), the RG-LRU block and its decode step, and the
state inits.  Values within 1e-5 (``TOL``: float32 sums in another order;
the SSD's decays within 2e-5 of their magnitude).  Then the port's own
invariant: a prefill of S tokens followed by t decode steps gives the
logits of a prefill of S + t tokens, for both recurrent archs (the
hybrid's attention windowed), within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

TOL = dict(rtol=0, atol=1e-5)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(torch_get_config(arch).reduced(), compute_dtype="float32", **kw)
    return jcfg, tcfg


def _mixer(jcfg, init, seed=0):
    """A mixer's JAX params and the port's copy; the zero-initialized
    vectors drawn nonzero so that they enter the comparison."""
    tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    for i, name in enumerate(("conv_b", "dt_bias", "norm", "D")):
        if name in tree:
            tree[name] = tree[name] + _rand(tree[name].shape, 50 + i, 0.3)
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _cfgs("mamba2_370m")
    jp, tp = _mixer(jcfg, jssm.mamba2_init)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def rglru():
    jcfg, tcfg = _cfgs("recurrentgemma_2b")
    jp, tp = _mixer(jcfg, jssm.rglru_init)
    return jcfg, tcfg, jp, tp


def test_causal_conv_and_its_step(mamba):
    _, _, jp, tp = mamba
    x = _rand((2, 9, jp["conv_w"].shape[1]), 1)
    np.testing.assert_allclose(_np(tssm._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"])),
                               _np(jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])), **TOL)
    state, xt = _rand((2, 3, x.shape[-1]), 2), _rand((2, x.shape[-1]), 3)
    got = tssm._conv_step(torch.from_numpy(xt), torch.from_numpy(state), tp["conv_w"], tp["conv_b"])
    want = jssm._conv_step(jnp.asarray(xt), jnp.asarray(state), jp["conv_w"], jp["conv_b"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_conv_step_refuses_a_short_state_where_the_reference_fails(mamba):
    """A prefill shorter than conv_kernel - 1 leaves a shorter conv state:
    the reference's step fails on the shapes, the port's names the cause."""
    _, _, jp, tp = mamba
    state, xt = _rand((1, 2, jp["conv_w"].shape[1]), 4), _rand((1, jp["conv_w"].shape[1]), 5)
    with pytest.raises(ValueError):
        jssm._conv_step(jnp.asarray(xt), jnp.asarray(state), jp["conv_w"], jp["conv_b"])
    with pytest.raises(ValueError, match="conv_kernel - 1 = 3"):
        tssm._conv_step(torch.from_numpy(xt), torch.from_numpy(state), tp["conv_w"], tp["conv_b"])


def test_split_proj(mamba):
    jcfg, tcfg, _, _ = mamba
    d_inner, nheads = tssm.mamba2_dims(tcfg)
    assert (d_inner, nheads) == jssm.mamba2_dims(jcfg)
    z = _rand((2, 3, 2 * d_inner + 2 * tcfg.ssm_state + nheads), 6)
    for g, w in zip(tssm._split_proj(torch.from_numpy(z), tcfg), jssm._split_proj(jnp.asarray(z), jcfg)):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("s,chunk", [(16, 8), (24, 8), (12, 8), (11, 8), (5, 64)],
                         ids=["divides", "three_chunks", "halved_to_4", "odd_to_1", "shorter_than_chunk"])
def test_ssd_chunked(s, chunk):
    b, h, p, n = 2, 4, 8, 16
    xh, bm, cm = _rand((b, s, h, p), 7), _rand((b, s, n), 8, 0.5), _rand((b, s, n), 9, 0.5)
    dt = np.abs(_rand((b, s, h), 10, 0.3)) + 0.05
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    got = tssm._ssd_chunked(*(torch.from_numpy(t) for t in (xh, bm, cm, dt, a_log)), chunk)
    want = jssm._ssd_chunked(*(jnp.asarray(t) for t in (xh, bm, cm, dt, a_log)), chunk)
    for g, w in zip(got, want):
        scale = float(np.abs(_np(w)).max())
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=2e-5 * max(scale, 1.0))


@pytest.mark.parametrize("s", [16, 11], ids=["divides_chunk", "not_divisible"])
def test_mamba2_forward_and_decode(mamba, s):
    jcfg, tcfg, jp, tp = mamba
    x = _rand((2, s, tcfg.d_model), 11)
    jq, tq = jssm.DEFAULT_QUANT, QuantPolicy.bf16()
    np.testing.assert_allclose(_np(tssm.mamba2_forward(torch.from_numpy(x), tp, tcfg, quant=tq)),
                               _np(jssm.mamba2_forward(jnp.asarray(x), jp, jcfg, quant=jq)), **TOL)
    jstate = {"h": jnp.asarray(_rand((2, *jssm.mamba2_state_init(jcfg, 1)["h"].shape[1:]), 12, 0.2)),
              "conv": jnp.asarray(_rand((2, *jssm.mamba2_state_init(jcfg, 1)["conv"].shape[1:]), 13))}
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    got_y, got_s = tssm.mamba2_decode(torch.from_numpy(x[:, :1]), tp, tcfg, tstate, quant=tq)
    want_y, want_s = jssm.mamba2_decode(jnp.asarray(x[:, :1]), jp, jcfg, jstate, quant=jq)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(got_s[k]), _np(want_s[k]), **TOL)


def test_prefill_state_equals_the_reference(mamba, rglru):
    """The {"h", "conv"} decode states the prefill leaves (the reference's
    ``transformer._mamba_prefill`` / ``_rglru_prefill``)."""
    from repro.models import transformer as jtf

    for (jcfg, tcfg, jp, tp), jfn, tfn in ((mamba, jtf._mamba_prefill, tssm.mamba2_prefill),
                                           (rglru, jtf._rglru_prefill, tssm.rglru_prefill)):
        x = _rand((2, 13, tcfg.d_model), 14)
        got_y, got_s = tfn(torch.from_numpy(x), tp, tcfg, QuantPolicy.bf16())
        want_y, want_s = jfn(jnp.asarray(x), jp, jcfg, jssm.DEFAULT_QUANT)
        np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(_np(got_s[k]), _np(want_s[k]), **TOL)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_rglru_scan_is_the_references_associative_scan(s):
    """The recursion on tensors against ``jax.lax.associative_scan`` with
    the reference's combine: the same grouping of the products."""
    a = 1.0 / (1.0 + np.exp(-_rand((2, s, 8), 15)))
    b = _rand((2, s, 8), 16)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = tssm.rglru_scan(torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-6)
    h, ref = np.zeros((2, 8), np.float32), []
    for t in range(s):  # the sequential recurrence the scan computes
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    np.testing.assert_allclose(_np(got[1]), np.stack(ref, 1), rtol=0, atol=1e-5)


def test_rglru_gates_forward_and_decode(rglru):
    jcfg, tcfg, jp, tp = rglru
    jq, tq = jssm.DEFAULT_QUANT, QuantPolicy.bf16()
    xb = _rand((2, 5, tcfg.lru_width), 17)
    for g, w in zip(tssm._rglru_gates(torch.from_numpy(xb), tp, tq), jssm._rglru_gates(jnp.asarray(xb), jp, jq)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    x = _rand((2, 13, tcfg.d_model), 18)
    np.testing.assert_allclose(_np(tssm.rglru_forward(torch.from_numpy(x), tp, tcfg, quant=tq)),
                               _np(jssm.rglru_forward(jnp.asarray(x), jp, jcfg, quant=jq)), **TOL)
    shapes = {k: v.shape for k, v in jssm.rglru_state_init(jcfg, 2).items()}
    jstate = {"h": jnp.asarray(_rand(shapes["h"], 19, 0.5)), "conv": jnp.asarray(_rand(shapes["conv"], 20))}
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    got_y, got_s = tssm.rglru_decode(torch.from_numpy(x[:, :1]), tp, tcfg, tstate, quant=tq)
    want_y, want_s = jssm.rglru_decode(jnp.asarray(x[:, :1]), jp, jcfg, jstate, quant=jq)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(got_s[k]), _np(want_s[k]), **TOL)


@pytest.mark.parametrize("which", ["mamba", "rglru"])
def test_state_inits(mamba, rglru, which):
    jcfg, tcfg, _, _ = mamba if which == "mamba" else rglru
    jinit, tinit = ((jssm.mamba2_state_init, tssm.mamba2_state_init) if which == "mamba" else
                    (jssm.rglru_state_init, tssm.rglru_state_init))
    want = jinit(jcfg, 3, dtype=jnp.bfloat16)
    got = tinit(tcfg, 3, device="cpu", dtype=torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert all(float(v.abs().sum()) == 0 for v in got.values())


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_2b"])
def test_decode_steps_continue_the_prefill(arch):
    """prefill(S) then t decode steps (teacher-forced) == prefill(S + t)'s
    last logits at each length, within 1e-5: the recurrent step continues
    the chunked SSD / associative scan, and the hybrid's windowed decode
    continues its windowed prefill (S + t crosses the window of 8)."""
    _, tcfg = _cfgs(arch)
    params = ttf.init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(21).integers(1, tcfg.vocab_size, (2, 14)))
    s, policy = 6, QuantPolicy.bf16()
    with torch.no_grad():
        _, caches, _ = ttf.prefill(params, toks[:, :s], tcfg, policy, max_len=32)
        cur = torch.full((2,), s)
        for t in range(s, toks.shape[1]):
            got, caches = ttf.decode_step(params, toks[:, t], caches, cur, tcfg, policy)
            want, _, _ = ttf.prefill(params, toks[:, :t + 1], tcfg, policy, max_len=32)
            np.testing.assert_allclose(_np(got), _np(want), err_msg=f"position {t}", **TOL)
            cur = cur + 1


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_2b"])
def test_init_caches_are_the_references(arch):
    """One empty decode state per layer, the shapes and dtypes of the
    reference's stacked ``init_caches`` (the hybrid's attention layer a
    bf16 K/V cache of max_len positions)."""
    from repro.models import transformer as jtf

    jcfg, tcfg = _cfgs(arch)
    want = [{k: (tuple(v.shape[1:]), str(v.dtype)) for k, v in g.items()} for g in jtf.init_caches(jcfg, 2, 16)
            for _ in range(next(iter(g.values())).shape[0])]
    got = [{k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in c.items()}
           for c in ttf.init_caches(tcfg, 2, 16, device="cpu")]
    assert got == want and len(got) == tcfg.num_layers
