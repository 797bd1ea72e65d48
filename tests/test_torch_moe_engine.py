"""The port's engine on reduced ``dbrx_132b`` (3 MoE layers, 4 experts,
top-2, KVH = H = 4) under the packed W4 + RaZeR KV policy, against the JAX
package's engine in float32: the tests of ``_torch_moe_cases``."""
import pytest

from _torch_moe_cases import *  # noqa: F401,F403  (the shared tests and the ``case`` fixture)


@pytest.fixture(scope="module")
def variant():
    return ("dbrx", "w4_kv")
