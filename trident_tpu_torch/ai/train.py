"""Frame-interpolation trainer: L1 + Adam, PSNR/SSIM eval, early stopping,
checkpoints.

Port of trident_tpu/ai/train.py (the reference's Scripts/
train_frame_generator.py main loop, :462-573): L1 loss, Adam, per-epoch
PSNR/SSIM on a validation split, early stop on best PSNR, periodic
checkpoints, JSON-lines logs.

Differences by design:
- the optimizer is torch.optim.Adam with optax.adam's defaults (betas
  0.9 / 0.999, eps 1e-8, no eps inside the root);
- a checkpoint is a torch.save file (the net's state dict) in a
  `step_NNNNNN/` directory, where the JAX package writes orbax; the
  directory's latest.json keeps its contract (`step`, the step
  directory's name relative to the checkpoint directory, and
  `base_channels`);
- the dataset yields the JAX layout, (B, H, W, 6); the loop converts each
  batch to the net's NCHW once, and `train_step` / `eval_step` take NCHW.

Everything runs on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from trident_tpu_torch import resolve_device
from trident_tpu_torch.ai.dataset import TripletDataset
from trident_tpu_torch.ai.metrics import psnr, ssim
from trident_tpu_torch.ai.model import InterpolationUNet, init_model
from trident_tpu_torch.core.log import get_logger

logger = get_logger("ai.train")

CHECKPOINT_FILE = "checkpoint.pt"
ADAM_BETAS = (0.9, 0.999)     # optax.adam's defaults
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    """The net being trained and its optimizer; `step` counts updates."""

    model: InterpolationUNet
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclass
class TrainConfig:
    source: str = "Dataset"
    resolution: Tuple[int, int] = (256, 256)
    base_channels: int = 32
    batch_size: int = 4
    learning_rate: float = 2e-4
    epochs: int = 50
    val_fraction: float = 0.1
    early_stop_patience: int = 8
    checkpoint_dir: str = "checkpoints/frame_generator"
    checkpoint_every: int = 5
    seed: int = 0
    log_path: Optional[str] = None
    skip_training: bool = False   # CI path: init + save untrained, like --skip-training


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults."""
    return torch.optim.Adam(params, lr=learning_rate, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


def create_state(config: TrainConfig, bn_group=None,
                 device=None) -> TrainState:
    """A fresh net (init_model from a generator seeded with config.seed)
    and its Adam. `bn_group` syncs every BatchNorm's moments over that
    process group, as the JAX create_state's bn_axis_name does over a mesh
    axis."""
    gen = torch.Generator().manual_seed(config.seed)
    model = init_model(gen, config.resolution, config.base_channels,
                       bn_group=bn_group, device=device)
    return TrainState(model, make_optimizer(model.parameters(),
                                            config.learning_rate))


def l1_loss(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(prediction - target))


def all_reduce_mean(tensors, group, n: Optional[int] = None) -> None:
    """Sum each of `tensors` over `group` (one all-reduce of them
    flattened) and divide by n (default: the group's size), in place."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group) if n is None else n
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def train_step(state: TrainState, inputs: torch.Tensor,
               targets: torch.Tensor, group=None):
    """One optimizer step on NCHW `inputs` (B, 6, H, W) and `targets` (B,
    3, H, W); BatchNorm in training mode updates its running stats.
    With `group` (data parallelism over processes, the JAX step's
    axis_name) the gradients and the loss are averaged over it. Returns
    (state, loss, out), the state updated in place."""
    model = state.model
    model.train()
    out = model(inputs)
    loss = l1_loss(out, targets)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    if group is not None:
        loss = loss.clone()
        all_reduce_mean([p.grad for p in model.parameters()] + [loss],
                        group)
    state.optimizer.step()
    state.step += 1
    return state, loss, out.detach()


@torch.no_grad()
def eval_step(state: TrainState, inputs: torch.Tensor,
              targets: torch.Tensor):
    """(l1, psnr, ssim) of the net in eval mode on NCHW inputs."""
    model = state.model
    model.eval()
    out = model(inputs)
    return l1_loss(out, targets), psnr(out, targets), ssim(out, targets)


def save_checkpoint(state: TrainState, directory: str, step: int,
                    update_latest: bool = True) -> str:
    """Write the net's state dict to `directory/step_NNNNNN/` and return
    that directory. `update_latest=False` writes the step dir WITHOUT
    retargeting latest.json: periodic resume snapshots must not displace
    the early-stopping BEST model that every loader (load_checkpoint,
    validate.py, FrameGenerator) resolves through latest.json."""
    path = os.path.abspath(os.path.join(directory, f"step_{step:06d}"))
    os.makedirs(path, exist_ok=True)
    torch.save(state.model.state_dict(), os.path.join(path, CHECKPOINT_FILE))
    if update_latest:
        with open(os.path.join(directory, "latest.json"), "w") as f:
            # the step dir NAME, not an absolute path (the checkpoint
            # directory stays relocatable), and the net width, so loaders
            # need no TrainConfig
            bc = int(state.model.enc0.weight.shape[0])
            json.dump({"step": step, "path": os.path.basename(path),
                       "base_channels": bc}, f)
    return path


def load_checkpoint(directory: str, config: Optional[TrainConfig] = None,
                    path: Optional[str] = None,
                    device=None) -> InterpolationUNet:
    """The net (eval mode, on `device`, the card unless given) restored
    from a checkpoint directory through its latest.json, or from the step
    directory `path`. The width is latest.json's `base_channels` where it
    has one, else config.base_channels."""
    config = config or TrainConfig()
    if path is None:
        with open(os.path.join(directory, "latest.json")) as f:
            latest = json.load(f)
        path = latest["path"]
        if "base_channels" in latest:
            config = replace(config, base_channels=int(latest["base_channels"]))
        if not os.path.isabs(path):
            path = os.path.join(directory, path)
        elif not os.path.exists(path):
            path = os.path.join(directory, os.path.basename(path))
    state = torch.load(os.path.join(path, CHECKPOINT_FILE),
                       map_location="cpu", weights_only=True)
    net = InterpolationUNet(base_channels=config.base_channels)
    net.load_state_dict(state)
    return net.eval().to(resolve_device(device))


def _mean(values) -> float:
    """The mean of a list of 0-d tensors, in float64 (the JAX loop's
    np.mean of their floats)."""
    return float(torch.stack(values).double().mean())


def _nchw(batch: np.ndarray, device) -> torch.Tensor:
    """A (B, H, W, C) numpy batch as a contiguous (B, C, H, W) tensor."""
    return torch.from_numpy(batch).to(device).permute(0, 3, 1, 2).contiguous()


def train(config: TrainConfig, device=None) -> Dict[str, Any]:
    """Run the training loop; returns summary dict (best PSNR etc.)."""
    device = resolve_device(device)
    state = create_state(config, device=device)
    os.makedirs(config.checkpoint_dir, exist_ok=True)

    if config.skip_training:
        path = save_checkpoint(state, config.checkpoint_dir, 0)
        return {"best_psnr": 0.0, "epochs_run": 0, "checkpoint": path}

    dataset = TripletDataset(config.source, config.resolution)
    train_idx, val_idx = dataset.split(config.val_fraction, config.seed)

    log_f = open(config.log_path, "a") if config.log_path else None
    best_psnr = -1.0
    best_path = None
    patience = 0
    rng = np.random.default_rng(config.seed)
    epochs_run = 0

    try:
        for epoch in range(config.epochs):
            epochs_run = epoch + 1
            t0 = time.time()
            order = rng.permutation(train_idx)
            losses = []
            for inputs, targets in dataset.batches(order, config.batch_size):
                state, loss, _ = train_step(state, _nchw(inputs, device),
                                            _nchw(targets, device))
                losses.append(loss)

            val_l1, val_psnr, val_ssim = [], [], []
            for inputs, targets in dataset.batches(val_idx,
                                                   config.batch_size):
                l1, p, s = eval_step(state, _nchw(inputs, device),
                                     _nchw(targets, device))
                val_l1.append(l1)
                val_psnr.append(p)
                val_ssim.append(s)

            # one readback an epoch: the losses stay on the device until here
            record = {
                "epoch": epoch,
                "train_l1": _mean(losses),
                "val_l1": _mean(val_l1),
                "val_psnr": _mean(val_psnr),
                "val_ssim": _mean(val_ssim),
                "seconds": time.time() - t0,
            }
            logger.info("epoch %d: %s", epoch, json.dumps(record))
            if log_f:
                log_f.write(json.dumps(record) + "\n")
                log_f.flush()

            if record["val_psnr"] > best_psnr:
                best_psnr = record["val_psnr"]
                best_path = save_checkpoint(state, config.checkpoint_dir,
                                            epoch)
                patience = 0
            else:
                patience += 1
                if patience >= config.early_stop_patience:
                    logger.info("early stop at epoch %d (best PSNR %.2f)",
                                epoch, best_psnr)
                    break
            if (config.checkpoint_every
                    and (epoch + 1) % config.checkpoint_every == 0):
                # resume snapshot only: latest.json keeps pointing at the BEST
                save_checkpoint(state, config.checkpoint_dir, epoch,
                                update_latest=False)
    finally:
        if log_f:
            log_f.close()
    return {"best_psnr": best_psnr, "epochs_run": epochs_run,
            "checkpoint": best_path}
