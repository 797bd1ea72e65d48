"""Disaggregated prefill/decode serving over wire-format KV page transfer
(PyTorch port of ``repro.serving.disagg``).

Splits ``Engine.serve``'s single loop into prefill replicas, decode
replicas and a prefix-aware router, connected by ``PageShipment``: the
RaZeR 4.5-bit wire format crossing a (modelled) host boundary.
"""
from .orchestrator import DisaggConfig, DisaggReport, serve_disagg
from .router import Placement, RadixView, Router
from .workers import DecodeWorker, PrefillWorker

__all__ = [
    "DisaggConfig",
    "DisaggReport",
    "serve_disagg",
    "Placement",
    "RadixView",
    "Router",
    "DecodeWorker",
    "PrefillWorker",
]
