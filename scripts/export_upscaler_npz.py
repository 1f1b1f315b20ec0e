#!/usr/bin/env python
"""Export the shipped 2x upscaler checkpoint to the port's numpy file.

    JAX_PLATFORMS=cpu python scripts/export_upscaler_npz.py \
        [assets_out/upscaler_2x] [trident_tpu_torch/assets/upscaler_2x.npz]

The checkpoint is an orbax directory that only the JAX package can read.
This script restores it with `trident_tpu.ai.upscaler.load_upscaler` and
writes every parameter array under its flax name ("Conv_0/kernel",
"Conv_0/bias", ...; kernels HWIO) plus the fields of meta.json as 0-d
integer arrays, uncompressed. `trident_tpu_torch.ai.upscaler.load_upscaler`
reads that file without jax or orbax. The arrays are written as restored,
bit for bit (tests/test_torch_upscaler.py checks it).
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts of arrays → {"a/b": np.ndarray}."""
    flat = {}
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}{key}"
        if isinstance(value, dict) or hasattr(value, "items"):
            flat.update(flatten(dict(value), name + "/"))
        else:
            flat[name] = np.asarray(value)
    return flat


def main() -> None:
    src = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "assets_out", "upscaler_2x")
    dst = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        ROOT, "trident_tpu_torch", "assets", "upscaler_2x.npz")
    from trident_tpu.ai.upscaler import load_upscaler

    params, _bc = load_upscaler(src)
    arrays = flatten(params)
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    for key, value in meta.items():
        arrays[key] = np.asarray(int(value), np.int64)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    np.savez(dst, **arrays)
    n = sum(a.size for k, a in arrays.items() if "/" in k)
    print(f"wrote {dst}: {len(arrays)} arrays, {n} parameters, meta {meta}")


if __name__ == "__main__":
    main()
