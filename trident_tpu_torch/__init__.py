"""trident_tpu_torch — the PyTorch/CUDA port of trident_tpu's renderer.

The forward frame of a rigid, textured, lit scene (binning → visibility →
attribute resolve → texel fetch → Cook-Torrance PBR), with the directional
shadow pass (depth-only light raster → shadow taps) and the post stages
(bloom, supersample resolve), runs here on plain PyTorch tensors; the
per-pixel hot spots are hand-written CUDA kernels for Hopper (csrc/, built
at first use by _build.py). The port imports nothing of the JAX package
`trident_tpu`: it keeps its own copies of the host layers it needs (core/,
ecs/, geometry/, io/image.py). The JAX package stays the reference the
port is tested against.

Entry points run on the card: a device of None means "cuda", and without
a card that raises. The CPU runs only when the caller asks for it with
device="cpu" (the tests do).

Importing this package pins TF32 off: the reference pins
`Precision.HIGHEST` wherever positions flow, and TF32 matmuls are the
card's counterpart of that precision hazard.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device to run on: `device`, or the card when None. A CUDA
    request on a machine without a card raises — work never moves to the
    CPU behind the caller's back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


# TRIDENT_THREAD_CHECKS=1: install the cross-thread mutation detector
# (core/threadcheck.py — the validation-layer analogue). No-op otherwise.
from trident_tpu_torch.core.threadcheck import maybe_install as _maybe_threadcheck  # noqa: E402

_maybe_threadcheck()
