"""The port's engine on a two-group MoE decoder against the JAX package's,
float32: reduced ``dbrx_132b`` with ``first_dense_layers=1`` and one shared
expert, cut to 2 layers (``layers_0`` the dense layer, ``layers_1`` the MoE
layer), under the packed W4A4 + KV policy (the shared experts' linears see
the activation fake-quant, the grouped expert products do not, as in the
reference): prefill and decode logits, KV bytes and ``generate`` tokens of
``_torch_moe_cases``; ``test_torch_moe_serve_groups.py`` serves the same
model."""
import pytest

from _torch_moe_cases import (case, test_generate_tokens_match,  # noqa: F401  (collected here)
                              test_kv_cache_bytes_after_prefill_match, test_prefill_and_decode_logits_match)


@pytest.fixture(scope="module")
def variant():
    return ("dbrx_fd1s1", "w4a4_kv")
