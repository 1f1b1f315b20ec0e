"""Multi-device dry run: one training step of the interpolation net over a
(dp, tp) grid of processes, the same step with explicit collectives, and
the banded frame.

Port of trident_tpu/parallel/dryrun.py. The JAX package is one program
over a mesh: GSPMD shards the step from the parameters' and the batch's
shardings, and shard_map runs the explicit-collective branch. Here the
dry run starts n processes (torch.distributed, one rank per mesh cell)
and gives each a device: on the CPU n CPU ranks under gloo; on the card
cuda:(rank % device_count), under NCCL when every rank has a card of its
own and under gloo (on the CUDA tensors) when ranks share one, since NCCL
refuses two ranks on one device. Both steps run in the same processes:

- the dp×tp step (the GSPMD step, trident_tpu/parallel/dryrun.py:35-89):
  rank (d, t) holds batch shard d and, of every parameter that
  parallel/mesh.py's rule shards, output-channel shard t
  (`TensorParallelUNet`: column-parallel convs). A channel gather joins
  the activations after each sharded layer: forward the shards summed
  into place by one all-reduce, backward an all-reduce and a slice, both
  of which gloo runs on CPU and CUDA tensors. BatchNorm is local to each
  channel shard, its moments all-reduced over dp. The loss is computed on
  every tp rank and backpropagated at 1/tp, so that the gathers' summed
  gradients count it once; sharded parameters average their gradients
  over dp, replicated ones sum them over tp and average over dp;
- the explicit-collective step (:92-139): dp = n, ai/train.py's
  train_step with the loss and the gradients averaged and BatchNorm
  synced over all ranks (a batch tiled to a multiple of n).

The two losses must agree within 1e-4, as the JAX check holds them.
`include_render` then renders the banded frame (parallel/framebuffer.py)
over the n devices in this process, as the JAX dry run does.
"""

from __future__ import annotations

import queue
import socket
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from trident_tpu_torch.ai.model import InterpolationUNet, batch_norm_train
from trident_tpu_torch.ai.train import (
    TrainConfig,
    TrainState,
    all_reduce_mean,
    create_state,
    l1_loss,
    make_optimizer,
    train_step,
)
from trident_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    param_sharding,
    rank_devices,
)

Tensor = torch.Tensor

LOSS_TOL = 1e-4            # trident_tpu/parallel/dryrun.py:129
RUN_TIMEOUT_S = 600.0      # a dry run whose ranks outlive this is killed


class _GatherChannels(torch.autograd.Function):
    """(B, C/tp, H, W) shards → (B, C, H, W) on every rank of the tp group:
    each shard written into its slot of a zero tensor, then summed by one
    all-reduce. Backward: the gradients of the whole tensor summed over
    the group (each rank's holds its consumers' part), then this rank's
    slot."""

    @staticmethod
    def forward(ctx, shard: Tensor, group, size: int, index: int) -> Tensor:
        ctx.group, ctx.index, ctx.c = group, index, shard.shape[1]
        full = shard.new_zeros((shard.shape[0], shard.shape[1] * size,
                                *shard.shape[2:]))
        full[:, index * ctx.c:(index + 1) * ctx.c] = shard
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return (grad[:, ctx.index * ctx.c:(ctx.index + 1) * ctx.c],
                None, None, None)


class TensorParallelUNet:
    """Rank `rank`'s part of an InterpolationUNet on a (dp, tp) mesh: the
    blocks of its parameters and running stats that `specs` (mesh.py's
    param_sharding) assigns it, and the net's forward with each sharded
    conv computing this rank's output channels (column parallel),
    BatchNorm on those channels with its moments summed over `dp_group`,
    and a channel gather over `tp_group` after each sharded layer."""

    def __init__(self, full: InterpolationUNet, specs: Dict[str, Sharding],
                 mesh: Mesh, rank: int, tp_group, dp_group) -> None:
        self.specs, self.tp_group, self.dp_group = specs, tp_group, dp_group
        self.tp, self.tp_index = mesh.shape["tp"], mesh.coords(rank)["tp"]
        self.params = {
            name: specs[name].local(p.detach(), mesh, rank).clone()
            .requires_grad_(True) for name, p in full.named_parameters()}
        self.buffers = {
            name: specs[name].local(b, mesh, rank).clone()
            for name, b in full.named_buffers()
            if not name.endswith("num_batches_tracked")}

    def sharded(self, name: str) -> bool:
        return bool(self.specs[f"{name}.weight"].dims)

    def _gather(self, name: str, y: Tensor) -> Tensor:
        if not self.sharded(name):
            return y
        return _GatherChannels.apply(y, self.tp_group, self.tp,
                                     self.tp_index)

    def _conv(self, name: str, x: Tensor, stride: int = 1) -> Tensor:
        return F.conv2d(x, self.params[f"{name}.weight"],
                        self.params.get(f"{name}.bias"), stride=stride,
                        padding=1)

    def _dec(self, name: str, x: Tensor) -> Tensor:
        """flax's ConvTranspose(k=4, s=2, "SAME"), as InterpolationUNet's
        decoder runs it."""
        return self._gather(name, F.relu(F.conv_transpose2d(
            x, self.params[f"{name}.weight"], self.params[f"{name}.bias"],
            stride=2, padding=1)))

    def _bn(self, name: str, x: Tensor) -> Tensor:
        return batch_norm_train(
            x, self.params[f"{name}.weight"], self.params[f"{name}.bias"],
            self.buffers[f"{name}.running_mean"],
            self.buffers[f"{name}.running_var"], self.dp_group)

    def _block(self, k: int, x: Tensor) -> Tensor:
        pre = f"blocks.{k}."
        h = F.relu(self._bn(pre + "bn0", self._conv(pre + "conv0", x)))
        h = self._gather(pre + "conv0", h)
        h = self._bn(pre + "bn1", self._conv(pre + "conv1", h))
        if self.sharded(pre + "conv1"):
            x = x.chunk(self.tp, 1)[self.tp_index]
        return self._gather(pre + "conv1", F.relu(h + x))

    def forward(self, x: Tensor) -> Tensor:
        """(B, 6, H, W) → (B, 3, H, W), InterpolationUNet.forward in
        training mode."""
        enc = lambda name, x, stride=1: self._gather(  # noqa: E731
            name, F.relu(self._conv(name, x, stride)))
        skip1 = self._block(0, enc("enc0", x.float()))
        skip2 = self._block(1, enc("enc1", skip1, 2))
        h = self._block(2, enc("enc2", skip2, 2))
        h = self._block(4, self._block(3, h))
        h = self._block(5, self._dec("dec1", h)) + skip2
        h = self._block(6, self._dec("dec0", h)) + skip1
        return torch.sigmoid(self._gather("head", self._conv("head", h)))


def _state_from(job: dict, **net_kw) -> InterpolationUNet:
    """The job's initial net: its numpy state dict on a fresh net."""
    net = InterpolationUNet(base_channels=job["base_channels"], **net_kw)
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in job["state"].items()})
    return net


def _nchw(a: np.ndarray, device) -> Tensor:
    return torch.from_numpy(a).to(device).permute(0, 3, 1, 2).contiguous()


def _dp_tp_step(rank: int, devices: list, job: dict) -> dict:
    """One dp×tp training step (module docstring) on this rank."""
    world, device = len(devices), devices[rank]
    mesh = make_mesh(world, job["tp"], devices=devices)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    # every rank creates every group, in the same order
    tp_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp)))
                 for d in range(dp)]
    dp_groups = [dist.new_group(list(range(t, world, tp)))
                 for t in range(tp)]
    at = mesh.coords(rank)
    full = _state_from(job).to(device)
    specs = param_sharding(mesh, full)
    net = TensorParallelUNet(full, specs, mesh, rank, tp_groups[at["dp"]],
                             dp_groups[at["tp"]])
    opt = make_optimizer(net.params.values(), job["lr"])
    batch = batch_sharding(mesh, 4)
    x = batch.local(_nchw(job["inputs"], device), mesh, rank)
    y = batch.local(_nchw(job["targets"], device), mesh, rank)

    out = net.forward(x)
    loss = l1_loss(out, y)
    opt.zero_grad(set_to_none=True)
    (loss / tp).backward()
    loss = loss.detach().clone()
    all_reduce_mean([p.grad for n, p in net.params.items() if specs[n].dims]
                    + [loss], dp_groups[at["tp"]])
    all_reduce_mean([p.grad for n, p in net.params.items()
                     if not specs[n].dims], None, dp)
    opt.step()
    return {"loss": float(loss), "out_shape": tuple(out.shape),
            "stats": {k: v.cpu().numpy() for k, v in net.buffers.items()},
            "grads": {k: p.grad.cpu().numpy() for k, p in net.params.items()},
            "dims": {k: s.dims for k, s in specs.items()},
            "mesh": mesh.shape, "coords": at}


def _explicit_step(rank: int, devices: list, job: dict) -> dict:
    """ai/train.py's train_step over all ranks: dp = n, the loss and the
    gradients averaged, BatchNorm synced (module docstring)."""
    world, device = len(devices), devices[rank]
    net = _state_from(job, bn_group=dist.group.WORLD).to(device)
    state = TrainState(net, make_optimizer(net.parameters(), job["lr"]))
    x = _nchw(job["inputs"], device).chunk(world)[rank]
    y = _nchw(job["targets"], device).chunk(world)[rank]
    state, loss, out = train_step(state, x, y, group=dist.group.WORLD)
    stats = {k: v.cpu().numpy() for k, v in net.state_dict().items()
             if "running_" in k}
    return {"loss": float(loss), "out_shape": tuple(out.shape),
            "stats": stats,
            "grads": {k: p.grad.cpu().numpy()
                      for k, p in net.named_parameters()}}


STEPS = {"dp_tp": _dp_tp_step, "explicit": _explicit_step}


def _backend(devices) -> str:
    """gloo on the CPU and where ranks share a card; NCCL where each rank
    has a card of its own."""
    if devices[0].type == "cpu":
        return "gloo"
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


def _rank_main(rank: int, devices, init_method: str, inbox,
               results) -> None:
    torch.set_num_threads(1)
    jobs = inbox.get()
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(devices), init_method=init_method,
                            world_size=len(devices), rank=rank)
    try:
        for i, job in enumerate(jobs):
            results.put((i, rank, STEPS[job["kind"]](rank, devices, job)))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_jobs(devices, jobs: list, timeout: float = RUN_TIMEOUT_S) -> list:
    """Run `jobs` (dicts: "kind" in STEPS, "state" the initial net as a
    numpy state dict, "base_channels", "inputs" / "targets" the whole
    NHWC batch, "lr", and for dp_tp "tp") in one process per device of
    `devices`, one process group for all of them. Returns, per job, the
    ranks' results in rank order. A rank that fails, or a run past
    `timeout` seconds, raises."""
    devices = [torch.device(d) for d in devices]
    ctx = mp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = mp.start_processes(
        _rank_main, args=(devices, f"tcp://127.0.0.1:{_free_port()}", inbox,
                          results),
        nprocs=len(devices), join=False, start_method="spawn")
    # the jobs go through a queue, not the processes' arguments: a start
    # waits until the new process has read its arguments, which it does
    # only after importing torch, so large arguments serialize the starts
    for _ in devices:
        inbox.put(jobs)
    got = {}
    deadline = time.monotonic() + timeout
    try:
        # drain the queue while the ranks run: joining first can deadlock
        while len(got) < len(jobs) * len(devices):
            try:
                i, rank, out = results.get(timeout=1.0)
                got[i, rank] = out
            except queue.Empty:
                if procs.join(timeout=0):          # raises if a rank failed
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dry run ranks still running after "
                                       f"{timeout:.0f} s")
        while not procs.join(timeout=max(deadline - time.monotonic(), 1.0)):
            if time.monotonic() > deadline:
                raise TimeoutError("dry run ranks did not exit")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        # a rank that died unread leaves the jobs in the pipe: do not wait
        # at exit to flush them
        inbox.cancel_join_thread()
    if len(got) != len(jobs) * len(devices):
        raise RuntimeError(f"dry run returned {len(got)} of "
                           f"{len(jobs) * len(devices)} rank results")
    return [[got[i, r] for r in range(len(devices))]
            for i in range(len(jobs))]


def tile_batch(inputs: np.ndarray, targets: np.ndarray, n: int):
    """The batch tiled up to lcm(batch, n) samples: every sample repeated
    equally often, so the mean loss and the BatchNorm moments are
    unchanged and the batch splits into n equal shards."""
    reps = int(np.lcm(inputs.shape[0], n)) // inputs.shape[0]
    return (np.tile(inputs, (reps, 1, 1, 1)),
            np.tile(targets, (reps, 1, 1, 1)))


def dryrun_jobs(state: dict, inputs: np.ndarray, targets: np.ndarray,
                base_channels: int, n: int, tp: int,
                lr: float) -> list:
    """The dry run's two jobs on one initial net and batch: the dp×tp step
    at (n // tp, tp) on the batch, the explicit step at dp = n on it
    tiled to a multiple of n."""
    common = dict(state=state, base_channels=base_channels, lr=lr)
    ex_in, ex_tg = tile_batch(inputs, targets, n)
    return [dict(kind="dp_tp", tp=tp, inputs=inputs, targets=targets,
                 **common),
            dict(kind="explicit", inputs=ex_in, targets=ex_tg, **common)]


def run_dryrun(n_devices: int, resolution=(32, 32), batch_per_device: int = 1,
               base_channels: int = 8, include_render: bool = True,
               device=None) -> dict:
    """The dry run on n_devices ranks (mesh.py's rank_devices: the card's
    devices unless device="cpu"): both training steps, their lines, the
    1e-4 check of the two losses, then with `include_render` the banded
    frame over the same devices. Returns {"dp_tp": [per-rank results],
    "explicit": [...]} (results as the steps return them)."""
    devices = rank_devices(n_devices, device)
    mesh = make_mesh(n_devices, devices=devices)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    config = TrainConfig(resolution=resolution, base_channels=base_channels,
                         batch_size=dp * batch_per_device)
    state = {k: v.numpy() for k, v in
             create_state(config, device="cpu").model.state_dict().items()}
    b, (h, w) = config.batch_size, resolution
    rng = np.random.default_rng(0)
    inputs = rng.random((b, h, w, 6), np.float32)
    targets = rng.random((b, h, w, 3), np.float32)
    print(f"dryrun ranks: {n_devices} processes, backend "
          f"{_backend(devices)}, devices {[str(d) for d in devices]}",
          flush=True)
    dp_tp, explicit = run_jobs(devices, dryrun_jobs(
        state, inputs, targets, base_channels, n_devices, tp,
        config.learning_rate))
    check_dryrun(dp_tp, explicit, (b, h, w, 3))
    if include_render:
        dryrun_banded_render(devices)
    return {"dp_tp": dp_tp, "explicit": explicit}


def check_dryrun(dp_tp: list, explicit: list, out_shape) -> None:
    """The dry run's checks and lines on its ranks' results: the dp×tp
    step's loss finite and its outputs the batch's (B, H, W, 3) in dp
    shards; the explicit step's loss within LOSS_TOL of it and its synced
    BatchNorm stats equal on every rank. Raises RuntimeError on a miss."""
    mesh = dp_tp[0]["mesh"]
    b, h, w, _c = out_shape
    gspmd = dp_tp[0]["loss"]
    shapes = {r["out_shape"] for r in dp_tp}
    if not np.isfinite(gspmd) or shapes != {(b // mesh["dp"], 3, h, w)}:
        raise RuntimeError(f"dp×tp step: loss {gspmd}, out shapes {shapes}")
    print(f"dryrun_multichip OK: mesh={mesh} loss={gspmd:.4f} "
          f"out={tuple(out_shape)}", flush=True)
    loss = explicit[0]["loss"]
    if not np.isfinite(loss) or abs(loss - gspmd) >= LOSS_TOL:
        raise RuntimeError(f"explicit-collective loss {loss:.6f} != dp×tp "
                           f"loss {gspmd:.6f}")
    for r in explicit[1:]:
        for k, v in r["stats"].items():
            if not np.array_equal(v, explicit[0]["stats"][k]):
                raise RuntimeError(f"synced BatchNorm stat {k} differs "
                                   "across ranks")
    print(f"dryrun explicit collectives OK: dp={len(explicit)} "
          f"loss={loss:.4f} (GSPMD {gspmd:.4f})", flush=True)


def dryrun_banded_render(devices, size: int = 64) -> None:
    """The banded frame over `devices` on the kernel route with a shadowed
    sun (parallel/framebuffer.py), in this process: a cube at size² (grown
    so that every band holds whole 32-row tiles) through
    render_frame_banded, the Renderer's bundled (2-blob) banded frame
    against it, then the banded 2× frame of a zero-head init_upscaler net
    over min(2, n) bands."""
    from trident_tpu_torch.ai.upscaler import init_upscaler
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        LightComponent, LightType, MeshComponent, TransformComponent)
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.ops.raster import TILE
    from trident_tpu_torch.parallel.framebuffer import render_frame_banded
    from trident_tpu_torch.render.renderer import Renderer
    from trident_tpu_torch.tools_dev.banded import banded_kwargs, frame_diffs

    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def scene(side: int) -> Renderer:
        r = Renderer(EngineConfig(render=RenderConfig(
            width=side, height=side, shadows=True, shadow_pcf=True,
            shadow_map_size=side)), device=devices[0])
        reg = Registry()
        r.set_active_registry(reg)
        e = reg.create()
        reg.add(e, TransformComponent())
        reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(
            PrimitiveType.CUBE)))
        sun = reg.create()
        reg.add(sun, TransformComponent())
        reg.add(sun, LightComponent(
            light_type=LightType.DIRECTIONAL,
            direction=np.array([-0.4, -1.0, -0.3], np.float32),
            cast_shadows=True))
        r.editor_camera.set_viewport_size(side, side)
        r.editor_camera.set_position([0, 0, 3])
        r.editor_camera.look_at_target([0, 0, 0])
        return r

    size = max(size, n * TILE)
    r = scene(size)
    out = render_frame_banded(devices, **banded_kwargs(r.frame_inputs()))
    covered = int((out.tri_id >= 0).sum())
    aux = out.aux.reshape(-1, 2).sum(0).tolist()
    saux = ([0, 0] if out.shadow_aux is None
            else out.shadow_aux.reshape(-1, 2).sum(0).tolist())
    if tuple(out.color.shape) != (size, size, 4) or covered == 0 \
            or aux != [0, 0] or saux != [0, 0]:
        raise RuntimeError(f"banded render: shape {tuple(out.color.shape)}, "
                           f"covered {covered}, aux {aux}, light aux {saux}")
    print(f"dryrun banded render OK: {n} bands (pallas+shadows), "
          f"covered px={covered}", flush=True)
    bundled = r.render_viewport(devices=devices)
    if frame_diffs(bundled, out):
        raise RuntimeError(f"bundled banded frame differs in "
                           f"{frame_diffs(bundled, out)}")
    print(f"dryrun bundled banded OK: {n} bands, 2-blob uploads", flush=True)

    # neural 2× on bands: half-size bands + the V1 upscaler on the joined
    # frame; a zero-head net is the bilinear base, so the frame must stay
    # a valid full-size frame
    net = init_upscaler(torch.Generator().manual_seed(0), base_channels=8,
                        device=devices[0])
    nb = min(2, n)
    half = nb * TILE
    kw = banded_kwargs(scene(half).frame_inputs())
    kw.update(upscale_params=net, prev=None)
    up = render_frame_banded(devices[:nb], **kw)
    if tuple(up.color.shape) != (2 * half, 2 * half, 4) \
            or not bool((up.tri_id >= 0).any()):
        raise RuntimeError(f"banded ai_upscale frame {tuple(up.color.shape)}")
    print(f"dryrun banded ai_upscale OK: {half}->{half * 2} over {nb} bands",
          flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the multi-device dry run")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="cpu for n CPU ranks (default: the card)")
    ap.add_argument("--no-render", action="store_true")
    a = ap.parse_args()
    run_dryrun(a.n, include_render=not a.no_render, device=a.device)
