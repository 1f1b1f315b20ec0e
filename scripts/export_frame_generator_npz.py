#!/usr/bin/env python
"""Export the shipped frame-interpolation checkpoint to the port's numpy
file.

    JAX_PLATFORMS=cpu python scripts/export_frame_generator_npz.py \
        [assets_out/frame_generator_128] \
        [trident_tpu_torch/assets/frame_generator_128.npz]

The checkpoint is an orbax directory that only the JAX package can read.
This script restores it with `trident_tpu.ai.train.load_checkpoint` and
writes every array of its `params` and `batch_stats` under its flax name
("params/Conv_0/kernel", "batch_stats/ResidualBlock_0/BatchNorm_0/mean",
...; conv kernels HWIO, transposed-conv kernels HWIO as flax keeps them)
plus `base_channels` as a 0-d integer array, uncompressed.
`trident_tpu_torch.ai.model.load_frame_generator` reads that file without
jax or orbax. The arrays are written as restored, bit for bit
(tests/test_torch_interp.py checks it).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from export_upscaler_npz import flatten  # noqa: E402


def main() -> None:
    src = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "assets_out", "frame_generator_128")
    dst = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        ROOT, "trident_tpu_torch", "assets", "frame_generator_128.npz")
    from trident_tpu.ai.train import load_checkpoint

    model, variables = load_checkpoint(src)
    arrays = flatten({"params": variables["params"],
                      "batch_stats": variables["batch_stats"]})
    arrays["base_channels"] = np.asarray(model.base_channels, np.int64)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    np.savez(dst, **arrays)
    n = sum(a.size for k, a in arrays.items() if "/" in k)
    print(f"wrote {dst}: {len(arrays)} arrays, {n} values, base_channels "
          f"{model.base_channels}")


if __name__ == "__main__":
    main()
