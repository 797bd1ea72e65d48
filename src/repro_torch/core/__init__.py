"""Numerics, wire format and quantization policy of the PyTorch port: NVFP4
and RaZeR, the §5.1 baseline formats, the format registry, per-tensor specs
and per-layer rules, and the offline quantization toolkit (SV calibration,
GPTQ, AWQ, the two-pass split)."""
from .baselines import fouroversix_quantize, int4_quantize, mxfp4_quantize, nf4_quantize
from .calibration import calibrate_activation_sv, select_weight_sv_pairs, sv_pair_sweep
from .formats import (
    FP4_MAX,
    FP4_NEG_ZERO_CODE,
    FP4_VALUES,
    float_format_values,
    fp4_decode,
    fp4_encode,
    positive_format_values,
    round_to_format,
    round_to_values,
)
from .nvfp4 import BlockQuantized, nvfp4_qdq, nvfp4_quantize
from .packing import (
    PackedRazerWeight,
    PackedStackedTensor,
    decode_offset_register,
    encode_offset_register,
    pack_fp4_codes,
    pack_stacked_weights,
    pack_weight,
    unpack_fp4_codes,
)
from .policy import (
    BF16,
    DEFAULT_DENSE_RULES,
    LayerRule,
    QuantPolicy,
    TensorSpec,
    as_policy,
    tree_paths,
)
from .qlinear import QuantConfig, QuantizedLinear, qdq_activation, qdq_weight, qlinear
from .razer import (
    ACT_SPECIAL_VALUES,
    WEIGHT_SPECIAL_VALUES,
    razer_qdq,
    razer_quantize,
    sv_pairs_to_set,
)
from .registry import FormatEntry, format_names, get_format, register_format, unregister_format

__all__ = [k for k in dir() if not k.startswith("_")]
