"""Shared tests of the port's engine on a packed MoE decoder against the JAX
package's, float32 compute.  A test file imports them and defines the
``variant`` fixture: (config name in ``_torch_serve_cases.ARCHS``, policy).
One JAX engine per variant (cached) serves every test of the file.

The expert banks are packed stacked containers and run through the grouped
GEMM's plain version.  The reduced configs' capacity factor (8.0) drops no
slot, so the serving invariants hold exactly.
"""
import numpy as np
import pytest

from _torch_engine_cases import check_greedy, compare_engines, kv_mismatch_fraction
from _torch_serve_cases import assert_same_report, engines, port_engine, prompts, serve_both
from repro_torch.core.packing import PackedStackedTensor
from repro_torch.models.transformer import layer_groups
from repro_torch.serving.pagepool import PagePoolConfig

LOGIT_TOL = 1e-5  # f32 sums in another order


@pytest.fixture(scope="module")
def case(variant):
    arch, policy = variant
    return compare_engines(*engines(policy, arch))


def test_prefill_and_decode_logits_match(case):
    for step, (got, want) in enumerate(zip(case["port_logits"], case["jax_logits"])):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL, err_msg=f"step {step} (0: prefill)")


def test_kv_cache_bytes_after_prefill_match(case):
    assert kv_mismatch_fraction(case) == 0.0


def test_generate_tokens_match(case):
    check_greedy(case, LOGIT_TOL)
    assert case["port_tokens"] == case["jax_tokens"]


def test_serve_matches_jax_with_fake_clock(variant):
    """Tokens, ServeReport counters and FakeClock latencies of a staggered
    stream over two slots and pages of 4, with a prefix-cache hit (prompts
    of one prefill bucket, so that the JAX engine compiles few shapes)."""
    arch, policy = variant
    ps = prompts((5, 7, 3, 8))
    ps[3][:4] = ps[1][:4]
    specs = [(p, 5, 0.01 * i, -1) for i, p in enumerate(ps)]
    jrep, trep = serve_both(specs, policy=policy, arch=arch, ps=4, num_pages=40, slots=2, tick=0.001)
    assert trep.cached_tokens > 0
    assert_same_report(jrep, trep, clocked=True)


def test_serving_invariants(variant):
    """serve == generate, prefix cache on == off, and speculation with a
    bf16 draft (the dense einsum branch over the banks) == vanilla."""
    arch, policy = variant
    eng = port_engine(policy, arch)
    moe_group = [t for t, _ in layer_groups(eng.cfg)].index("m")
    assert isinstance(eng.params[f"layers_{moe_group}"][0]["moe"]["experts"]["gate"], PackedStackedTensor)
    ps = prompts((5, 11, 17, 3), seed=2)
    ps[2][:8] = ps[1][:8]
    pool_cfg = PagePoolConfig(num_pages=48, page_size=4, max_len=64)
    base = eng.serve(ps, pool_cfg=pool_cfg)
    assert base.outputs == eng.generate(ps)
    off = eng.serve(ps, pool_cfg=pool_cfg, prefix_cache=False)
    assert off.outputs == base.outputs
    assert base.cached_tokens > 0 and off.cache_lookups == 0
    spec = eng.serve(ps, pool_cfg=pool_cfg, speculate_k=2, draft_policy="bf16")
    assert spec.outputs == base.outputs and spec.drafted_tokens > 0
