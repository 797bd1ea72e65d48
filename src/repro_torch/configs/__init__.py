"""Model configurations the port runs; ``get_config(name)`` by module name."""
import importlib

from repro_torch.models.config import ArchConfig

ARCHS = ("llama3_2_3b", "dbrx_132b")


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
