"""trident_tpu_torch — the PyTorch/CUDA port of trident_tpu's forward frame.

The default frame of a rigid, textured, lit scene (binning → visibility →
attribute resolve → texel fetch → Cook-Torrance PBR) runs here on plain
PyTorch tensors, with the three per-pixel hot spots as hand-written CUDA
kernels for Hopper (csrc/, built at first use by _build.py). The JAX package
`trident_tpu` stays the reference the port is tested against; of it, only
the jax-free host layers (ECS, meshes and primitives, config, log, the
checkerboard texture) are imported here.

Importing this package pins TF32 off: the reference pins
`Precision.HIGHEST` wherever positions flow, and TF32 matmuls are the
card's counterpart of that precision hazard.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> str:
    """"cuda" when a card is present, else "cpu"."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def resolve_device(device=None) -> torch.device:
    """The device to run on: `device`, or default_device() when None. An
    explicit CUDA request on a machine without a card raises — work never
    moves to the CPU behind the caller's back."""
    dev = torch.device(default_device() if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    return dev
