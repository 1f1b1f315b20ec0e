"""Device grids for data- and tensor-parallel training.

Port of trident_tpu/parallel/mesh.py. The JAX package builds a (dp, tp)
`jax.sharding.Mesh` and lets XLA place the collectives; here a mesh is
the same grid of torch devices, one process (rank) for each cell, rank
d·tp + t at row d (its batch shard) and column t (its channel shard), and
a `Sharding` says which dimension of a tensor each mesh axis splits.
parallel/dryrun.py runs the processes and their collectives.

The parameter rule is the JAX one: split a parameter's output-channel
axis over tp when that axis divides by tp and is at least max(tp,
min_size). In the JAX layout that axis is the last; in torch it is dim 0
of a conv's OIHW weight, a bias, a BatchNorm's weight, bias and running
stats, and dim 1 of a transposed conv's IOHW weight.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from trident_tpu_torch import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of devices; `devices[d, t]` is rank d·tp + t's."""

    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        dp, tp = self.devices.shape
        return {"dp": dp, "tp": tp}

    def coords(self, rank: int) -> Dict[str, int]:
        """{"dp": row, "tp": column} of `rank`."""
        dp_i, tp_i = divmod(rank, self.devices.shape[1])
        return {"dp": dp_i, "tp": tp_i}


@dataclass(frozen=True)
class Sharding:
    """For each mesh axis that splits a tensor, the dimension it splits
    (an empty map: replicated)."""

    dims: Dict[str, int]

    def local(self, x: torch.Tensor, mesh: Mesh, rank: int) -> torch.Tensor:
        """`rank`'s block of the whole tensor `x` (equal chunks)."""
        coords = mesh.coords(rank)
        for axis, dim in self.dims.items():
            x = x.chunk(mesh.shape[axis], dim)[coords[axis]]
        return x


def rank_devices(n: int, device=None) -> list:
    """The device of each of n ranks: n CPU ranks for device "cpu", else
    the card's devices in turn, cuda:(rank % device_count) (ranks share a
    card when there are fewer cards than ranks)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (dp, tp) mesh of `devices` (default: rank_devices(n) on the
    card). tp defaults to 2 when n is even, else 1."""
    if devices is None:
        if n_devices is None:
            n_devices = torch.cuda.device_count()
        devices = rank_devices(n_devices)
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    devices = devices[:n]
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // tp
    if dp * tp != n:
        raise ValueError(f"n_devices={n} not divisible by tp={tp}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, tp))


def out_channel_dim(module: nn.Module, name: str) -> int:
    """The torch dimension of a parameter or buffer that holds the JAX
    layout's last (output-channel) axis."""
    return 1 if isinstance(module, nn.ConvTranspose2d) and name == "weight" \
        else 0


def param_sharding(mesh: Mesh, model: nn.Module,
                   min_size: int = 2) -> Dict[str, Sharding]:
    """A Sharding for every parameter and buffer of `model`, by name: its
    output-channel dimension split over 'tp' when it divides by tp and is
    at least max(tp, min_size); replicated otherwise."""
    tp = mesh.shape["tp"]
    specs = {}
    for mod_name, mod in model.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) \
            + list(mod.named_buffers(recurse=False))
        for name, t in tensors:
            dim = out_channel_dim(mod, name)
            split = (t.dim() > dim and t.shape[dim] % tp == 0
                     and t.shape[dim] >= max(tp, min_size))
            key = f"{mod_name}.{name}" if mod_name else name
            specs[key] = Sharding({"tp": dim} if split else {})
    return specs


def batch_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Shard axis 0 (batch) over 'dp'; `ndim` is the tensor's rank (any
    rank ≥ 1 splits the same way)."""
    if ndim < 1:
        raise ValueError("a batch has at least one dimension")
    return Sharding({"dp": 0})
