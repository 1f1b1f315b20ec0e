"""Frame-interpolation network: residual U-Net, inference only.

Port of trident_tpu/ai/model.py (the reference's InterpolationUNet,
Scripts/train_frame_generator.py:139-217): an encoder of 3×3 convs
(c → 2c → 4c, stride 2 down), a residual block after each, two residual
bottleneck blocks, a transposed-conv decoder with ADDITIVE skips, and a
sigmoid head. Two frames concatenated on channels, (B, 6, H, W) in [0, 1],
give the middle frame, (B, 3, H, W). PyTorch layout (NCHW), f32 (TF32 is
pinned off in the package __init__), BatchNorm from its running
statistics; training is not ported.

The JAX package leaves these convolutions to XLA (`flax.linen.Conv`,
`ConvTranspose`), outside any Pallas kernel, so here they are
`torch.nn` layers. Weights: `load_frame_generator` reads the numpy export
of the shipped orbax checkpoint (assets/frame_generator_128.npz, written
by scripts/export_frame_generator_npz.py), and `params_from_flax` maps the
flax names and layouts onto the module.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trident_tpu_torch import resolve_device

Tensor = torch.Tensor

DEFAULT_WEIGHTS = Path(__file__).resolve().parents[1] / "assets" / \
    "frame_generator_128.npz"
EXPORT_SCRIPT = "scripts/export_frame_generator_npz.py"
BN_EPS = 1e-5            # flax.linen.BatchNorm's default epsilon


class ResidualBlock(nn.Module):
    """relu(BN(conv(relu(BN(conv(x))))) + x), 3×3 convs without bias."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv0 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(channels, eps=BN_EPS)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels, eps=BN_EPS)

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(h)) + x)


class InterpolationUNet(nn.Module):
    """(B, 6, H, W) frame pair → (B, 3, H, W) middle frame; H and W are
    multiples of 4."""

    def __init__(self, input_channels: int = 6,
                 base_channels: int = 32) -> None:
        super().__init__()
        c = base_channels
        self.input_channels, self.base_channels = input_channels, c
        self.enc0 = nn.Conv2d(input_channels, c, 3, padding=1)
        self.enc1 = nn.Conv2d(c, 2 * c, 3, stride=2, padding=1)
        self.enc2 = nn.Conv2d(2 * c, 4 * c, 3, stride=2, padding=1)
        # flax's ConvTranspose(k=4, s=2, padding="SAME") doubles the size
        # as this does with its kernel flipped (params_from_flax flips it)
        self.dec1 = nn.ConvTranspose2d(4 * c, 2 * c, 4, stride=2, padding=1)
        self.dec0 = nn.ConvTranspose2d(2 * c, c, 4, stride=2, padding=1)
        self.head = nn.Conv2d(c, 3, 3, padding=1)
        # flax's ResidualBlock_0 … _6, in call order
        self.blocks = nn.ModuleList(ResidualBlock(ch) for ch in (
            c, 2 * c, 4 * c, 4 * c, 4 * c, 2 * c, c))

    def forward(self, x: Tensor) -> Tensor:
        b = self.blocks
        skip1 = b[0](F.relu(self.enc0(x.float())))
        skip2 = b[1](F.relu(self.enc1(skip1)))
        h = b[2](F.relu(self.enc2(skip2)))
        h = b[4](b[3](h))
        h = b[5](F.relu(self.dec1(h))) + skip2
        h = b[6](F.relu(self.dec0(h))) + skip1
        return torch.sigmoid(self.head(h))


def _hwio_to_oihw(kernel) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def _flax_transpose_kernel(kernel) -> Tensor:
    """flax's ConvTranspose kernel (kh, kw, in, out), which it applies
    unflipped, → torch's ConvTranspose2d weight (in, out, kh, kw), which
    torch applies flipped: flip both spatial axes."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)))


def params_from_flax(params, batch_stats) -> dict:
    """The JAX package's variables (nested dicts of arrays: `params` with
    Conv_0…3, ConvTranspose_0…1, ResidualBlock_0…6/{Conv_i/kernel,
    BatchNorm_i/{scale, bias}}, and `batch_stats` with
    ResidualBlock_k/BatchNorm_i/{mean, var}) → an InterpolationUNet state
    dict."""
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    state = {}
    for name, flax_name in (("enc0", "Conv_0"), ("enc1", "Conv_1"),
                            ("enc2", "Conv_2"), ("head", "Conv_3")):
        state[f"{name}.weight"] = _hwio_to_oihw(params[flax_name]["kernel"])
        state[f"{name}.bias"] = f32(params[flax_name]["bias"])
    for name, flax_name in (("dec1", "ConvTranspose_0"),
                            ("dec0", "ConvTranspose_1")):
        state[f"{name}.weight"] = _flax_transpose_kernel(
            params[flax_name]["kernel"])
        state[f"{name}.bias"] = f32(params[flax_name]["bias"])
    for k in range(7):
        p, s = params[f"ResidualBlock_{k}"], batch_stats[f"ResidualBlock_{k}"]
        for i in range(2):
            pre = f"blocks.{k}."
            state[f"{pre}conv{i}.weight"] = _hwio_to_oihw(
                p[f"Conv_{i}"]["kernel"])
            bn, stats = p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"]
            state[f"{pre}bn{i}.weight"] = f32(bn["scale"])
            state[f"{pre}bn{i}.bias"] = f32(bn["bias"])
            state[f"{pre}bn{i}.running_mean"] = f32(stats["mean"])
            state[f"{pre}bn{i}.running_var"] = f32(stats["var"])
            state[f"{pre}bn{i}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
    return state


def unet_from_flax(params, batch_stats, device=None) -> InterpolationUNet:
    """An inference InterpolationUNet (eval mode, no gradients) holding the
    JAX package's variables, on `device` (the card unless given)."""
    state = params_from_flax(params, batch_stats)
    in_ch = state["enc0.weight"].shape[1]
    bc = state["enc0.weight"].shape[0]
    net = InterpolationUNet(input_channels=in_ch, base_channels=bc)
    net.load_state_dict(state)
    net.requires_grad_(False)
    return net.eval().to(resolve_device(device))


def load_frame_generator(path=None,
                         device=None) -> Tuple[InterpolationUNet, int]:
    """(net, base_channels) from the numpy export of the checkpoint
    (default assets/frame_generator_128.npz). Anything but an .npz file
    written by the export script raises: the orbax directory the JAX
    package reads is not readable here."""
    path = Path(path) if path else DEFAULT_WEIGHTS
    if path.suffix != ".npz" or not path.is_file():
        raise ValueError(f"{path}: the frame generator loads only the .npz "
                         f"that {EXPORT_SCRIPT} writes from an orbax "
                         "checkpoint")
    with np.load(path) as z:
        tree = {}
        for key in z.files:
            if "/" in key:
                node = tree
                *parents, leaf = key.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = z[key]
        bc = int(z["base_channels"])
    net = unet_from_flax(tree["params"], tree["batch_stats"], device)
    if bc != net.base_channels:
        raise ValueError(f"{path}: base_channels {bc} disagrees with the "
                         f"arrays ({net.base_channels})")
    return net, bc


def unet_flops(base_channels: int, height: int, width: int,
               input_channels: int = 6) -> int:
    """Multiply-adds × 2 of one forward pass at (height, width): each conv
    2·k²·C_in·C_out per output pixel, each transposed conv 2·k²·C_in·C_out
    per input pixel; BatchNorm, ReLU, the skips and the sigmoid are not
    counted."""
    c, hw = base_channels, height * width
    conv = lambda cin, cout, px: 2 * 9 * cin * cout * px  # noqa: E731
    block = lambda ch, px: 2 * conv(ch, ch, px)            # noqa: E731
    return (conv(input_channels, c, hw) + block(c, hw)
            + conv(c, 2 * c, hw // 4) + block(2 * c, hw // 4)
            + conv(2 * c, 4 * c, hw // 16) + 3 * block(4 * c, hw // 16)
            + 2 * 16 * 4 * c * 2 * c * (hw // 16) + block(2 * c, hw // 4)
            + 2 * 16 * 2 * c * c * (hw // 4) + block(c, hw)
            + conv(c, 3, hw))
