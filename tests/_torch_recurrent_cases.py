"""Shared tests of the recurrent archs (reduced ``mamba2_370m`` and
``recurrentgemma_2b``), imported by each arch's test file beside its
``case`` (``_torch_zoo_cases.run_case``) and ``zoo``
(``_torch_zoo_walk_cases.walk_case``) fixtures: the decode states after the
exact-length prefill against the reference's, the packed tree byte for byte
under both packed policies, and ``generate``'s refusals and its handling of
short prompts beside the reference's."""
import jax
import numpy as np
import pytest
import torch

from _torch_engine_cases import _policies
from _torch_zoo_cases import KV_NAMES, MAX_LEN, RECURRENT_PROMPTS
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import pack_model_weights as jax_pack_model_weights
from repro_torch.core.packing import PackedRazerWeight
from repro_torch.serving.engine import pack_model_weights

STATE_TOL = 1e-5  # f32: the scans and matmuls sum in another order than XLA's


def test_decode_states_match(case):
    """Each layer's decode state after the prefill: the recurrent ``h``
    (float32) and ``conv`` (the last conv_kernel - 1 inputs) within
    STATE_TOL; an attention layer's cache byte for byte under the KV policy,
    else within STATE_TOL."""
    jl, tl = case["caches"]
    for li, (want, got) in enumerate(zip(jl, tl)):
        assert set(got) == set(want), (li, set(got), set(want))
        for name in got:
            if name in KV_NAMES:
                np.testing.assert_array_equal(got[name], want[name], err_msg=f"layer {li} {name}")
            else:
                np.testing.assert_allclose(got[name], want[name].astype(np.float32), rtol=0, atol=STATE_TOL,
                                           err_msg=f"layer {li} {name}")
        if "h" in got:
            assert got["h"].dtype == np.float32 and got["conv"].shape[1] == case["cfg"].conv_kernel - 1


def _packed_leaves(tree, path=""):
    """{path: numpy leaf} of a packed tree; a packed weight gives its codes,
    scale/meta bytes and tensor scale, a port layer list its layers stacked
    as the reference stacks a scan group."""
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_packed_leaves(val, f"{path}/{key}"))
        return out
    if isinstance(tree, list):
        per = [_packed_leaves(layer, path) for layer in tree]
        return {k: np.stack([p[k] for p in per]) for k in per[0]}
    if isinstance(tree, PackedRazerWeight) or type(tree).__name__ == "PackedRazerWeight":
        return {f"{path}/{f}": np.asarray(getattr(tree, f)) for f in ("codes", "scale_meta", "tensor_scale")}
    return {path: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("policy", ["w4_kv", "w4a4_kv"])
def test_packed_tree_bytes_equal_the_reference(zoo, policy):
    """``pack_model_weights`` packs the same leaves into the same bytes: the
    projections of the SSD and RG-LRU mixers and the MLPs; the conv taps,
    A_log, D, dt_bias, the gains and a_param stay dense and equal."""
    _, jcfg, tcfg, tree, eng = zoo
    jpol, tpol = _policies(policy)
    want = _packed_leaves(jax_pack_model_weights(jax.tree_util.tree_map(jax.numpy.asarray, tree), jcfg, jpol))
    got = _packed_leaves(pack_model_weights(eng._raw_params, tcfg, tpol))
    assert set(got) == set(want)
    for path in sorted(want):
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert any(p.endswith("mixer/out_proj/codes") for p in got)


def _jax_engine(zoo, n_new=4):
    _, jcfg, _, tree, _ = zoo
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jpol, _ = _policies("w4_kv")
    return JaxEngine(jparams, jcfg, JaxServeConfig(max_len=MAX_LEN, max_new_tokens=n_new, quant=jpol))


def test_unequal_prompt_lengths_refused_as_the_reference(zoo):
    """Padded steps would enter the recurrent state: the reference asserts
    equal lengths, the port raises a ValueError with its words."""
    _, _, _, _, eng = zoo
    prompts = [RECURRENT_PROMPTS[0], RECURRENT_PROMPTS[1][:7]]
    with pytest.raises(AssertionError, match="recurrent archs need equal prompt lengths"):
        _jax_engine(zoo).generate(prompts, max_new_tokens=2)
    with pytest.raises(ValueError, match="recurrent archs need equal prompt lengths"):
        eng.generate(prompts, max_new_tokens=2)


def test_short_prompts_fail_where_the_reference_fails(zoo):
    """A prompt shorter than conv_kernel - 1 tokens leaves a short conv
    state: the reference's first decode step fails on its shapes (a
    ValueError from the einsum), the port's raises a ValueError naming the
    cause at the same step; without a decode step both generate the same
    token, and at conv_kernel - 1 tokens both decode."""
    _, _, tcfg, _, eng = zoo
    jeng = _jax_engine(zoo)
    short = [[5, 6][: tcfg.conv_kernel - 2]]
    with pytest.raises(ValueError):
        jeng.generate(short, max_new_tokens=2)
    with pytest.raises(ValueError, match="prompts need >= 3 tokens to decode"):
        eng.generate(short, max_new_tokens=2)
    assert eng.generate(short, max_new_tokens=1) == jeng.generate(short, max_new_tokens=1)
    edge = [[5, 6, 7][: tcfg.conv_kernel - 1]]
    assert eng.generate(edge, max_new_tokens=3) == jeng.generate(edge, max_new_tokens=3)


def test_generate_prefills_at_the_exact_length(zoo):
    """No bucket: a padded step would enter the recurrent state."""
    _, _, _, _, eng = zoo
    out = eng.generate(RECURRENT_PROMPTS[:2], max_new_tokens=3)
    assert [len(o) for o in out] == [14, 14]
    assert eng.stats["bucket"] == len(RECURRENT_PROMPTS[0]) == 11
