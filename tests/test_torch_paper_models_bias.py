"""The paper-model tests, second file (``test_torch_paper_models.py`` has
the first): CodeQwen1.5-7B (qkv bias, MHA) and a G 7 model (reduced
DeepSeek-Coder-33B with 7 query heads over 1 KV head, hd 16) under W4 + KV
against the JAX engine; and Qwen3-8B (qk-norm) through ``Engine.serve`` on a
FakeClock against the JAX ``serve``: identical tokens, counters, TTFT and
latency lists.  Biases and norm gains nonzero from a seed in both packages.
"""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_engine_cases import perturb
from _torch_paper_cases import (PERTURB_SEED, build, test_decode_step_logits_match,  # noqa: F401
                                test_generate_greedy_tokens_match, test_kv_cache_bytes_match_in_every_layer,
                                test_prefill_last_logits_match)
from _torch_serve_cases import MAX_LEN, N_NEW, SHARED, assert_same_report, policies, requests
from repro.configs import get_config
from repro.models import transformer as jax_tf
from repro.obs import FakeClock as JaxFakeClock
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.obs import FakeClock
from repro_torch.serving.engine import Engine, ServeConfig

IDS = ["codeqwen1_5_7b-bias-mha-w4_kv", "deepseek_coder_33b-G7-w4_kv"]


@pytest.fixture(scope="module", params=IDS)
def case(request):
    return build(request.param)


def test_qwen3_serve_matches_jax_on_fake_clock():
    """Mixed lengths, a prefix shared at page size 4 (two full pages) and
    slot reuse over 2 slots."""
    from repro.serving.pagepool import PagePoolConfig as JaxPoolConfig
    from repro.serving.scheduler import SchedulerConfig as JaxSchedConfig
    from repro_torch.serving.pagepool import PagePoolConfig
    from repro_torch.serving.scheduler import SchedulerConfig

    jcfg = dataclasses.replace(get_config("qwen3_8b").reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(torch_get_config("qwen3_8b").reduced(), compute_dtype="float32")
    tree = perturb(jax.tree_util.tree_map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg)),
                   PERTURB_SEED)
    jpol, tpol = policies("w4_kv")
    je = JaxEngine(jax.tree_util.tree_map(jax.numpy.asarray, tree), jcfg,
                   JaxServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW, quant=jpol))
    te = Engine(params_from_numpy(tree, device="cpu"), tcfg,
                ServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW, quant=tpol), device="cpu")
    rng = np.random.default_rng(3)
    specs = [(SHARED + rng.integers(1, 256, size=n).tolist(), 6, 0.0, -1) for n in (3, 9)]
    specs += [(rng.integers(1, 256, size=n).tolist(), 5, 0.0, -1) for n in (5, 17)]
    jrep = je.serve(requests(specs, port=False), sched_cfg=JaxSchedConfig(max_slots=2),
                    pool_cfg=JaxPoolConfig(num_pages=48, page_size=4, max_len=MAX_LEN), clock=JaxFakeClock(tick=0.001))
    trep = te.serve(requests(specs, port=True), sched_cfg=SchedulerConfig(max_slots=2),
                    pool_cfg=PagePoolConfig(num_pages=48, page_size=4, max_len=MAX_LEN), clock=FakeClock(tick=0.001))
    assert_same_report(jrep, trep, clocked=True)
    assert trep.cached_tokens > 0 and trep.peak_slots == 2
