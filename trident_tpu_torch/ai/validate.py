"""Checkpoint/asset compatibility validation.

Port of trident_tpu/ai/validate.py (the reference's one registered CTest,
trident_onnx_validator, Trident/tools/ValidateOnnxAsset.cpp: asset exists
→ IR version supported → runtime can load the graph). Here it validates a
checkpoint directory that ai/train.py writes: exists → has latest.json →
restores into the current model definition → has the expected width →
produces the contracted output shape and range at the configured
resolution. The messages are the JAX package's.

    python3 -m trident_tpu_torch.ai.validate CHECKPOINT_DIR [--device cpu]
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class ValidationResult:
    ok: bool
    message: str


def validate_checkpoint(directory: str,
                        resolution: Tuple[int, int] = (256, 256),
                        base_channels: int = 32,
                        device=None) -> ValidationResult:
    if not os.path.isdir(directory):
        return ValidationResult(False, f"checkpoint dir not found: {directory}")
    if not os.path.exists(os.path.join(directory, "latest.json")):
        return ValidationResult(False, f"no latest.json in {directory} "
                                       "(not a trident_tpu checkpoint)")
    try:
        from trident_tpu_torch.ai.train import TrainConfig, load_checkpoint

        net = load_checkpoint(
            directory, TrainConfig(resolution=resolution,
                                   base_channels=base_channels),
            device=device)
    except Exception as exc:
        return ValidationResult(False, f"restore failed: {exc}")
    # latest.json carries the net width, so a mismatched expectation
    # restores FINE at the recorded width: compare the restored width to
    # the caller's contract explicitly
    got_bc = int(net.enc0.weight.shape[0])
    if got_bc != base_channels:
        return ValidationResult(
            False, f"architecture mismatch: checkpoint is {got_bc}-wide, "
                   f"expected base_channels={base_channels}")
    try:
        with torch.no_grad():
            x = torch.zeros((1, 6, resolution[0], resolution[1]),
                            device=net.enc0.weight.device)
            out = net(x).permute(0, 2, 3, 1)
    except Exception as exc:
        return ValidationResult(False, f"forward failed: {exc}")
    if tuple(out.shape) != (1, resolution[0], resolution[1], 3):
        return ValidationResult(False, f"bad output shape {tuple(out.shape)}")
    lo, hi = float(out.min()), float(out.max())
    if not (0.0 <= lo and hi <= 1.0):
        return ValidationResult(False, f"output outside [0,1]: [{lo},{hi}]")
    return ValidationResult(True, "checkpoint loads and satisfies the "
                                  f"{resolution} NHWC contract")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint_dir")
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--base-channels", type=int, default=32)
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    args = parser.parse_args(argv)
    result = validate_checkpoint(args.checkpoint_dir,
                                 (args.resolution, args.resolution),
                                 args.base_channels, args.device)
    print(("OK: " if result.ok else "FAIL: ") + result.message)
    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
