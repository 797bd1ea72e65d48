"""Model configurations the port runs; ``get_config(name)`` by module name.

``PAPER_ARCHS`` are the paper's own evaluation models (its Table 3; the
kernel microbenchmarks run on Llama-3.1-8B and Qwen3-32B)."""
import importlib

from repro_torch.models.config import ArchConfig

PAPER_ARCHS = ("llama2_7b", "llama3_1_8b", "qwen3_32b")
ARCHS = ("llama3_2_3b", "dbrx_132b", "llama3_1_8b", "llama2_7b", "qwen3_8b", "qwen3_32b", "codeqwen1_5_7b",
         "deepseek_coder_33b")


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
