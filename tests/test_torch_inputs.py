"""The input-shape table and the input specs against the JAX package's
(``repro.configs``, ``repro.models.inputs``): ``SHAPES``, ``ARCH_IDS``,
``all_configs`` and ``cells`` equal; every cell's specs of the same shapes
and dtypes; ``materialize`` drawing the same arrays (decode caches a layer
at a time, split from the reference's stacked groups); the cost model's
parameter counts and model FLOPs equal the reference's."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import costmodel as jax_cost
from repro.models import inputs as jax_inputs
from repro_torch import configs
from repro_torch.launch import costmodel
from repro_torch.models import inputs

SMALL = {"train": (32, 2), "prefill": (32, 2), "decode": (16, 2)}


def test_shape_table_and_arch_lists_equal_the_reference():
    assert configs.SHAPES == jax_configs.SHAPES
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert configs.PAPER_ARCH_IDS == jax_configs.PAPER_ARCH_IDS
    assert set(configs.ARCHS) == set(configs.ARCH_IDS) | set(configs.PAPER_ARCH_IDS)
    assert [c.name for c in configs.all_configs()] == [c.name for c in jax_configs.all_configs()]


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cells_equal_the_reference(arch):
    assert configs.cells(arch) == jax_configs.cells(arch)
    assert configs.get_config(arch).supports_decode == jax_configs.get_config(arch).supports_decode


def test_get_config_reads_dashes_and_dots():
    assert configs.get_config("llama3.2-3b") is configs.get_config("llama3_2_3b")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _jax_layers(jcaches, counts):
    """The reference's stacked per-group caches as per-layer numpy dicts."""
    out = []
    for group, n in zip(jcaches, counts):
        out += [{k: np.asarray(v[i].astype(np.float32) if v.dtype == jax.numpy.bfloat16 else v[i])
                 for k, v in group.items()} for i in range(n)]
    return out


@pytest.mark.parametrize("arch", ["llama3_2_3b", "dbrx_132b", "qwen2_vl_7b", "whisper_base", "recurrentgemma_2b",
                                  "deepseek_v2_236b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_specs_and_materialize_equal_the_reference(arch, kind):
    cfg, jcfg = configs.get_config(arch).reduced(), jax_configs.get_config(arch).reduced()
    shape = dict(zip(("seq_len", "global_batch"), SMALL[kind]), kind=kind)
    specs, jspecs = inputs.input_specs(cfg, shape), jax_inputs.input_specs(jcfg, shape)
    got = inputs.materialize(specs, seed=3, vocab=cfg.vocab_size, device="cpu")
    want = jax_inputs.materialize(jspecs, seed=3, vocab=cfg.vocab_size)
    if kind == "decode":
        counts = specs["caches"].counts
        want = dict(want, caches=_jax_layers(want["caches"], counts))
        jspecs = dict(jspecs, caches=[{k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype) for k, v in group.items()}
                                      for group, n in zip(jspecs["caches"], counts) for _ in range(n)])
        assert len(specs["caches"]) == cfg.num_layers
    assert sorted(specs) == sorted(jspecs)
    for s, js in zip(_leaves(specs), _leaves(jspecs)):
        assert s.device.type == "meta" and tuple(s.shape) == tuple(js.shape)
    for g, w in zip(_leaves(got), _leaves(want)):
        w = np.asarray(w.astype(np.float32) if w.dtype == jax.numpy.bfloat16 else w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.to(torch.float32).numpy() if g.is_floating_point() else g.numpy(), w)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "dbrx_132b", "deepseek_v2_236b", "mamba2_370m", "whisper_base"])
def test_cost_model_counts_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    assert costmodel.param_counts(cfg) == jax_cost.param_counts(jcfg)
    for kind in ("train", "prefill", "decode"):
        assert costmodel.model_flops(cfg, 4096, 8, kind) == jax_cost.model_flops(jcfg, 4096, 8, kind)


def test_roofline_uses_the_cards_peaks():
    terms = costmodel.roofline_terms(989e12, 3.35e12, 0.0)
    assert terms == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 0.0}
    assert costmodel.dominant({"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5}) == "memory_s"
