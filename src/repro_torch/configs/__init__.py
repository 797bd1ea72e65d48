"""Model configurations the port runs; ``get_config(name)`` by module name,
and the input-shape table (the counterpart of ``repro.configs``).

``ARCH_IDS`` are the assigned architectures, ``PAPER_ARCH_IDS`` the paper's
own evaluation models (its Table 3; the kernel microbenchmarks run on
Llama-3.1-8B and Qwen3-32B); ``ARCHS`` is every config the port has, both
lists together, and ``PAPER_ARCHS`` the paper's as a tuple."""
import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

PAPER_ARCH_IDS = ["llama2_7b", "llama3_1_8b", "qwen3_32b"]
ARCH_IDS = ["qwen2_vl_7b", "deepseek_coder_33b", "codeqwen1_5_7b", "llama3_2_3b", "qwen3_8b", "mamba2_370m",
            "recurrentgemma_2b", "deepseek_v2_236b", "dbrx_132b", "whisper_base"]
PAPER_ARCHS = tuple(PAPER_ARCH_IDS)
ARCHS = ("llama3_2_3b", "dbrx_132b", "llama3_1_8b", "llama2_7b", "qwen3_8b", "qwen3_32b", "codeqwen1_5_7b",
         "deepseek_coder_33b", "deepseek_v2_236b", "qwen2_vl_7b", "whisper_base", "recurrentgemma_2b", "mamba2_370m")

# canonical input shapes (seq_len, global_batch) and the step each feeds:
# train_4k a train step, prefill_32k a prefill, decode_32k and long_500k a
# decode step against caches of seq_len positions
SHAPES: Dict[str, dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def get_config(name: str) -> ArchConfig:
    """The config of ``name``; '-' and '.' read as '_' (``llama3.2-3b``)."""
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def all_configs() -> List[ArchConfig]:
    return [get_config(a) for a in ARCH_IDS]


def cells(arch_id: str) -> List[str]:
    """The shape names an arch takes: long_500k only where it supports
    long context, the decode shapes only where it decodes."""
    cfg = get_config(arch_id)
    out = []
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.supports_long_context:
            continue
        if spec["kind"] == "decode" and not cfg.supports_decode:
            continue
        out.append(name)
    return out
