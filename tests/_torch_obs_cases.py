"""Shared helpers of the observability tests: the JAX package's reduced
weights as one numpy tree (the order both packages walk), and the
comparison of two quantization reports (integers, strings, layer paths and
their order exact; floats within a relative tolerance)."""
import functools

import jax
import numpy as np

from _torch_serve_cases import _jax_params
from repro_torch.bridge import params_from_numpy


@functools.lru_cache(maxsize=None)
def numpy_params(arch: str = "llama3_2_3b"):
    """``_torch_serve_cases``' JAX weights as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, _jax_params(arch))


def jax_params(arch: str = "llama3_2_3b"):
    """The same tree as JAX arrays, keys in the numpy tree's order."""
    return jax.tree_util.tree_map(jax.numpy.asarray, numpy_params(arch))


def port_params(arch: str = "llama3_2_3b"):
    return params_from_numpy(numpy_params(arch), device="cpu")


def assert_reports_match(want, got, rel: float = 1e-7, path: str = "$"):
    """``got`` equals ``want`` key for key and item for item; a float is
    within ``rel`` of the reference's, everything else is equal and of the
    same type."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, want, got)
        for k in want:
            assert_reports_match(want[k], got[k], rel, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), (path, want, got)
        for i, (a, b) in enumerate(zip(want, got)):
            assert_reports_match(a, b, rel, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= rel * abs(want), (path, want, got)
    else:
        assert type(got) is type(want) and got == want, (path, want, got)
