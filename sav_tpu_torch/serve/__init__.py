"""Serving: bucket ladder, dynamic batcher, latency ledger, the engine, its
prediction-quality primitives, and the fleet (router, TCP transport,
supervised replica pool).

The names below load on first use, so that the stdlib-only modules (the
router, the fleet, the telemetry readers) import without torch.
"""

import importlib

_EXPORTS = {
    "ServeConfig": "sav_tpu_torch.serve.engine",
    "ServeEngine": "sav_tpu_torch.serve.engine",
    "build_infer_fn": "sav_tpu_torch.serve.engine",
    "output_digests": "sav_tpu_torch.serve.quality",
    "digested_infer_fn": "sav_tpu_torch.serve.quality",
    "make_probe_batch": "sav_tpu_torch.serve.quality",
    "fingerprint_logits": "sav_tpu_torch.serve.quality",
    "load_reference": "sav_tpu_torch.serve.quality",
    "store_reference": "sav_tpu_torch.serve.quality",
    "ProbeRunner": "sav_tpu_torch.serve.quality",
    "noise_params": "sav_tpu_torch.serve.quality",
    "Router": "sav_tpu_torch.serve.router",
    "RouterShedError": "sav_tpu_torch.serve.router",
    "ReplicaShedError": "sav_tpu_torch.serve.router",
    "ReplicaTransportError": "sav_tpu_torch.serve.router",
    "projected_wait_s": "sav_tpu_torch.serve.router",
    "read_router_summary": "sav_tpu_torch.serve.router",
    "ReplicaPool": "sav_tpu_torch.serve.fleet",
    "TcpTransport": "sav_tpu_torch.serve.fleet",
    "pid_alive": "sav_tpu_torch.serve.fleet",
    "read_endpoint": "sav_tpu_torch.serve.fleet",
    "read_endpoints": "sav_tpu_torch.serve.fleet",
    "write_endpoint": "sav_tpu_torch.serve.fleet",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'sav_tpu_torch.serve' has no attribute {name!r}")
