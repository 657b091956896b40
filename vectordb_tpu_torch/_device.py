"""The engine's device, chosen in one place.

The port runs on the first CUDA device. The CPU is used only when a caller
asks for it with `set_device("cpu")` (the CLI's `--device cpu`; the CPU
tests): every kernel then runs its plain PyTorch version. Without a CUDA
device and without that request, `default_device()` raises instead of
quietly serving from the CPU. Every device buffer (segment.DeviceVectorStore,
masks, query blocks) is created on the device returned here, and kernels
follow their tensors. TF32 is switched off for the whole process: every
matmul in the engine feeds an exact path (candidate order, the flat-scan
fallback), and TF32 keeps only about three decimal digits of each operand.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEVICES = ("cuda", "cpu")

_requested = "cuda"


def set_device(kind: str) -> None:
    """Selects the engine's device for the process: "cuda" (the default)
    or "cpu". Call it before creating tables: existing device buffers stay
    where they are."""
    global _requested
    if kind not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {kind!r}")
    _requested = kind


def default_device() -> torch.device:
    if _requested == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vectordb_tpu_torch runs on a CUDA device and PyTorch sees none; "
            "call vectordb_tpu_torch.set_device('cpu') (or start the server "
            "with --device cpu) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())

