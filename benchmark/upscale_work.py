"""The least time the card could take for a 2× upscaled frame's upscale
stage (from the program's `stage_mark_upscale` to its `end` mark),
counted from the configuration's own sizes and the shapes of the weights
it names, whatever implements the stage.

Operations: two for each multiply-add of the net's four 3×3 convs over
the half-size frame, 2·9·h·w·Σ in·out (the ReLUs, the residual, the base
and the clip are not counted). Bytes: the net's input read once (the
colour and the warped history with its validity, in f32), its blocks
written once as the uint8 history, and the RGBA8 display frame written
once.

Peaks: one NVIDIA H100 SXM at its 700 W limit (benchmark/work.py):
67 TFLOP/s of float32 outside the tensor cores (the configuration states
float32 convs, TF32 off), 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from benchmark.reference.upscaled_field import CHECKOUT
from benchmark.work import F32_OPS_PER_S, HBM_BYTES_PER_S

F32_BYTES = 4
BLOCK_BYTES = 12                 # a half-size pixel's 2×2 rgb, as bytes
DISPLAY_BYTES = 4 * 4            # its 2×2 RGBA8 display pixels


class UpscaleWork(NamedTuple):
    ops: float
    bytes: float

    def least_ms(self) -> float:
        """The larger of bytes over peak bandwidth and operations over
        peak float32 rate, in ms."""
        return 1e3 * max(self.bytes / HBM_BYTES_PER_S,
                         self.ops / F32_OPS_PER_S)


def conv_shapes(path) -> list:
    """(in, out) channels of each conv in a weights archive
    (`Conv_<i>/kernel`, (3, 3, in, out)), in order."""
    with np.load(path) as z:
        n = sum(k.endswith("/kernel") for k in z.files)
        return [tuple(z[f"Conv_{i}/kernel"].shape[2:]) for i in range(n)]


def upscale_work(cfg: dict) -> UpscaleWork:
    """The upscale stage's work at the configuration's render size (half
    its width and height) with the net its `upscaler` names."""
    h, w = cfg["height"] // 2, cfg["width"] // 2
    shapes = conv_shapes(CHECKOUT / cfg["upscaler"])
    ops = 2 * 9 * h * w * sum(i * o for i, o in shapes)
    in_channels = shapes[0][0]
    nbytes = h * w * (in_channels * F32_BYTES + BLOCK_BYTES + DISPLAY_BYTES)
    return UpscaleWork(float(ops), float(nbytes))
