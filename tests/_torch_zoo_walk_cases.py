"""Shared walk tests of the zoo's archs, imported by each arch's test file
beside its own ``zoo`` fixture (``walk_case``), so that a file's JAX
compiles serve both its engine and its walk tests: the paged pool refuses
MLA, encoder-decoder and frontend archs with the reference's words, so
``serve`` (vanilla and speculative) and ``serve_disagg`` raise them; the
paged and verify paths refuse them as the reference's do; the bridge
unstacks whisper's ``enc_layers``; ``pack_model_weights`` packs the same
paths (MLA's ``q_b`` and ``kv_b`` stay dense, three stacked expert banks in
DeepSeek-V2) and the quantization audit reports what the reference's
does."""
import jax
import numpy as np
import pytest
import torch

from _torch_obs_cases import assert_reports_match
from _torch_zoo_cases import MAX_LEN, N_NEW, configs, trees
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.obs.numerics import audit_model as jax_audit_model
from repro.serving.pagepool import KVPagePool as JaxPool
from repro.serving.pagepool import PagePoolConfig as JaxPoolConfig
from repro_torch.core.packing import PackedRazerWeight, PackedStackedTensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import transformer as ttf
from repro_torch.obs.numerics import audit_model
from repro_torch.serving.disagg import serve_disagg
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.pagepool import KVPagePool, PagePoolConfig


def _reference_refusal(jcfg):
    with pytest.raises(ValueError) as err:
        JaxPool(jcfg, JaxPoolConfig(num_pages=8, page_size=16, max_len=MAX_LEN))
    return str(err.value)


def walk_case(arch: str):
    """(arch, JAX config, port config, numpy tree, the port's packed W4 + KV
    engine) for the walk tests; DeepSeek-V2 with the query's low-rank path
    (its full config's), so q_b exists."""
    torch.set_num_threads(2)
    jcfg, tcfg = configs(arch, **({"q_lora_rank": 16} if arch == "deepseek_v2_236b" else {}))
    _, tree, tparams = trees(jcfg)
    eng = Engine(tparams, tcfg, ServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW,
                                            quant=QuantPolicy.packed(kv_quant=True)), device="cpu")
    return arch, jcfg, tcfg, tree, eng


def test_pool_refuses_with_the_reference_words(zoo):
    _, jcfg, tcfg, _, _ = zoo
    want = _reference_refusal(jcfg)
    assert "use Engine.generate" in want
    with pytest.raises(ValueError) as err:
        KVPagePool(tcfg, PagePoolConfig(num_pages=8, page_size=16, max_len=MAX_LEN), device="cpu")
    assert str(err.value) == want


@pytest.mark.parametrize("how", ["serve", "speculative", "disagg"])
def test_serving_paths_raise_the_pool_refusal(zoo, how):
    _, jcfg, _, _, eng = zoo
    want = _reference_refusal(jcfg)
    with pytest.raises(ValueError) as err:
        if how == "serve":
            eng.serve([[1, 2, 3]], max_new_tokens=2)
        elif how == "speculative":
            eng.serve([[1, 2, 3]], max_new_tokens=2, speculate_k=1, draft_policy=QuantPolicy.bf16())
        else:
            serve_disagg(eng, [[1, 2, 3]], max_new_tokens=2)
    assert str(err.value) == want


def test_paged_paths_refuse_as_the_reference(zoo):
    """The layer-level checks behind the pool's: MLA's, the SSM's and the
    RG-LRU's paged decode, and the verify step and prefix-cached prefill on
    non-GQA layer types."""
    arch, _, tcfg, _, eng = zoo
    tok = torch.zeros(1, dtype=torch.long)
    first = ttf.layer_groups(tcfg)[0][0]
    if first in ("s", "r"):
        state = "SSM" if first == "s" else "RG-LRU"
        with pytest.raises(ValueError, match=rf"paged KV decode supports GQA attention only \(not {state} state\)"):
            ttf.decode_step(eng.params, tok, [{}] * tcfg.num_layers, torch.zeros(1, dtype=torch.int32), tcfg,
                            eng.policy, pages=torch.zeros((1, 2), dtype=torch.int32))
        with pytest.raises(ValueError, match="speculative verify supports paged GQA attention stacks only, got "
                                             f"layer type '{first}'"):
            ttf.decode_verify(eng.params, tok[:, None], [], torch.zeros(1, dtype=torch.int32), tcfg, eng.policy,
                              pages=torch.zeros((1, 2), dtype=torch.int32))
        with pytest.raises(ValueError, match="prefix-cached prefill supports GQA attention stacks only"):
            ttf.prefill_paged_suffix(eng.params, tok[:, None], [], torch.zeros(1, dtype=torch.int32), 1, 1, tcfg,
                                     eng.policy)
    if tcfg.mla:
        with pytest.raises(ValueError, match=r"paged KV decode supports GQA attention only \(not MLA\)"):
            ttf.decode_step(eng.params, tok, [{}] * tcfg.num_layers, torch.zeros(1, dtype=torch.int32), tcfg,
                            eng.policy, pages=torch.zeros((1, 2), dtype=torch.int32))
    if tcfg.encoder_decoder:
        with pytest.raises(ValueError, match="speculative verify supports paged GQA attention stacks only, got "
                                             "layer type 'c'"):
            ttf.decode_verify(eng.params, tok[:, None], [], torch.zeros(1, dtype=torch.int32), tcfg, eng.policy,
                              pages=torch.zeros((1, 2), dtype=torch.int32))
        with pytest.raises(ValueError, match="prefix-cached prefill supports GQA attention stacks only"):
            ttf.prefill_paged_suffix(eng.params, tok[:, None], [], torch.zeros(1, dtype=torch.int32), 1, 1, tcfg,
                                     eng.policy)


def test_bridge_unstacks_the_encoder(zoo):
    arch, jcfg, _, tree, eng = zoo
    if not jcfg.encoder_decoder:
        assert "enc_layers" not in eng._raw_params
        return
    layers = eng._raw_params["enc_layers"]
    assert isinstance(layers, list) and len(layers) == jcfg.enc_layers
    for i, layer in enumerate(layers):
        np.testing.assert_array_equal(layer["mixer"]["wq"].numpy(), tree["enc_layers"]["mixer"]["wq"][i])
        np.testing.assert_array_equal(layer["mlp"]["up_b"].numpy(), tree["enc_layers"]["mlp"]["up_b"][i])


def _packed_paths(tree, path=""):
    """{path: container name} of every packed leaf; a layer list's leaves
    under the group's path, once."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_packed_paths(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, list):
        return _packed_paths(tree[0], path)
    return {path: type(tree).__name__} if isinstance(tree, (PackedRazerWeight, PackedStackedTensor)) else {}


def test_packed_paths_and_audit_equal_the_reference(zoo):
    arch, jcfg, tcfg, tree, eng = zoo
    paths = _packed_paths(eng.params)
    jtree = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    want = jax_audit_model(jtree, JaxPolicy.packed(kv_quant=True), model=arch)
    assert set(paths) == {layer["path"] for layer in want["layers"]}
    got = audit_model(eng._raw_params, eng.policy, packed=eng.params, model=arch)
    assert_reports_match(want, got)
    assert got["rollups"]["max_drift"] == 0.0
    assert not any(p.endswith("_b") for p in paths)  # kv_b, q_b and the biases stay dense
    stacked = sorted(p for p, kind in paths.items() if kind == "PackedStackedTensor")
    if tcfg.mla:
        assert {"layers_0/mixer/q_a", "layers_0/mixer/kv_a", "layers_0/mixer/wo"} <= set(paths)
    if tcfg.moe:
        assert stacked == ["layers_1/moe/experts/down", "layers_1/moe/experts/gate", "layers_1/moe/experts/up"]
        assert "layers_0/mlp/gate" in paths and "layers_1/moe/shared/gate" in paths
    if tcfg.encoder_decoder:
        assert {"enc_layers/mixer/wq", "enc_layers/mlp/up", "layers_0/xattn/wk"} <= set(paths)
