#!/usr/bin/env python
"""Train the frame-interpolation net on captured frames (CLI).

Port of scripts/train_frame_generator.py, the workflow analogue of the
reference's Scripts/train_frame_generator.py (PyTorch→ONNX): frames in, a
checkpoint directory out (ai/train.py; FrameGenerator.initialise and
ai/validate.py read it) — no export step, the same card serves inference
inline in the render loop.

Examples:
  python3 -m trident_tpu_torch.scripts.train_frame_generator \\
      --source Dataset --epochs 20 --resolution 256 \\
      --checkpoint-dir checkpoints/framegen
  python3 -m trident_tpu_torch.scripts.train_frame_generator --skip-training
Add --device cpu to run on the CPU (default: the card).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--source", default="Dataset",
                        help="frame directory or glob (sorted by name)")
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--base-channels", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--learning-rate", type=float, default=2e-4)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--val-fraction", type=float, default=0.1)
    parser.add_argument("--early-stop-patience", type=int, default=8)
    parser.add_argument("--checkpoint-dir", default="checkpoints/frame_generator")
    parser.add_argument("--checkpoint-every", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-json", default=None,
                        help="append per-epoch JSON lines to this file")
    parser.add_argument("--skip-training", action="store_true",
                        help="init + save an untrained checkpoint (CI refresh)")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    from trident_tpu_torch.ai.train import TrainConfig, train

    config = TrainConfig(
        source=args.source,
        resolution=(args.resolution, args.resolution),
        base_channels=args.base_channels,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        epochs=args.epochs,
        val_fraction=args.val_fraction,
        early_stop_patience=args.early_stop_patience,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        seed=args.seed,
        log_path=args.log_json,
        skip_training=args.skip_training,
    )
    summary = train(config, device=args.device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
