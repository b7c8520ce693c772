"""PyTorch/CUDA port of cook_tpu's device path (NVIDIA Hopper).

The device-resident sequential match cycle — packed delta scatters, DRU
rank, quota/considerable filter, the Fenzo-style sequential match and
the compaction/provenance epilogue — in plain PyTorch, with the whole
sequential match walk as one hand-written CUDA kernel for sm_90a
(`ops/fused_match.py`, `csrc/exact_scan.cu`).

The package imports torch and numpy only: never jax and nothing of
`cook_tpu`; what it needs from host-only modules there is copied here.
Entry points take an explicit `device` ("cuda" by default) and raise
when CUDA is absent unless the caller asked for "cpu".

Importing the package imports nothing else: the node agent, the client,
the `cs` CLI and the API-server stand-in are host-only and run without
torch; each device module imports it where it is used.
"""
__version__ = "0.1.0"

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from cook_tpu_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
