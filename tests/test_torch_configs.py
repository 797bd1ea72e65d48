"""The port's model configurations against the JAX package's: every config
the port runs (``ARCHS``), full width and ``reduced()``, equal field by
field on every field the port's ``ArchConfig`` has, and ``PAPER_ARCHS`` the
reference's ``PAPER_ARCH_IDS``."""
import dataclasses

import pytest

from repro.configs import PAPER_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro_torch.configs import ARCHS, PAPER_ARCHS, get_config
from repro_torch.models.config import ArchConfig

FIELDS = [f.name for f in dataclasses.fields(ArchConfig)]


def _fields(cfg):
    return {name: getattr(cfg, name) for name in FIELDS}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_the_reference(arch, reduced):
    port, ref = get_config(arch), jax_get_config(arch)
    if reduced:
        port, ref = port.reduced(), ref.reduced()
    assert _fields(port) == _fields(ref)
    assert port.hd == ref.hd


def test_the_port_has_no_field_the_reference_lacks():
    ref = {f.name for f in dataclasses.fields(type(jax_get_config("llama3_2_3b")))}
    assert set(FIELDS) <= ref


def test_paper_archs_are_the_reference_set():
    assert PAPER_ARCHS == tuple(PAPER_ARCH_IDS)
    assert set(PAPER_ARCHS) <= set(ARCHS)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba2_370m")
