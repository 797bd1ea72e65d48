"""``Engine.serve`` of the two-group MoE decoder of
``test_torch_moe_engine_groups.py`` (a dense layer, then an MoE layer with a
shared expert; W4A4 + KV) against the JAX package's, and the port's serving
invariants on it: the serve tests of ``_torch_moe_cases``, in a file of
their own so that each file builds one JAX engine in about a minute."""
import pytest

from _torch_moe_cases import test_serve_matches_jax_with_fake_clock, test_serving_invariants  # noqa: F401


@pytest.fixture(scope="module")
def variant():
    return ("dbrx_fd1s1", "w4a4_kv")
