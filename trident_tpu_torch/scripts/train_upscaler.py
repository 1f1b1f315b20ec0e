#!/usr/bin/env python
"""Train the 2× super-resolution net (ai/upscaler.py) on procedurally
generated render pairs — no dataset needed: the renderer IS the data
generator, and both run on the same card.

Port of scripts/train_upscaler.py. Each sample renders one random scene
twice with the same camera: the target at full resolution and the input
at half resolution (a real half-res render, aliasing and all — exactly
what the ai_upscale mode feeds the net at runtime). Reports PSNR vs the
bilinear baseline on a held-out set and saves the net with
`save_upscaler` (an .npz in the --out directory, which a Renderer's
`ai.upscaler_path` loads).

    python3 -m trident_tpu_torch.scripts.train_upscaler --pairs 192 \\
        --steps 1500 --out assets_out/upscaler_2x [--device cpu]

The pools, their random draws (numpy, per pool seed) and the loop's batch
draws are the JAX script's, so a seed renders the same scenes. The loss
is L1 plus the edge term; the optimizer is Adam (optax.adam's defaults)
over optax's cosine_decay_schedule(lr, steps, 0.02): update k uses
lr(k) from k = 0, the last one 0.02·lr at k = steps. Everything runs on
the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import math
import statistics
import time
from typing import List, Optional

import numpy as np
import torch

from trident_tpu_torch import resolve_device

# the three static-axis pools samples round-robin across: the shadowed
# medium grid (editor scenes), a dense unshadowed grid (the 1M-sphere
# bench character: many small high-frequency silhouettes), and a sparse
# unshadowed closeup (cube512 / single-object scenes)
POOL_SPECS = (
    dict(shadows=True, grid=6, spread=4.5, scale_range=(0.4, 1.4)),
    dict(shadows=False, grid=10, spread=5.5, scale_range=(0.25, 0.7)),
    dict(shadows=False, grid=2, spread=2.0, scale_range=(0.8, 1.8)),
)
EVAL_EVERY = 100
COSINE_ALPHA = 0.02


def build_pool(res: int, seed: int, *, shadows: bool = True, grid: int = 6,
               spread: float = 4.5, scale_range=(0.4, 1.4), device=None):
    """One scene topology (one Renderer on `device`, the card unless
    given); randomness lives in transforms, camera, lights and texture
    assignment. Pools differ in the static axes: shadow pass on/off and
    entity count (geometry density). Returns (renderer, registry,
    entities, sun, rng, (spread, scale_range))."""
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        LightComponent, LightType, MeshComponent, TextureComponent,
        TransformComponent)
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.io.image import checkerboard
    from trident_tpu_torch.render.renderer import Renderer

    rng = np.random.default_rng(seed)
    r = Renderer(EngineConfig(render=RenderConfig(
        width=res, height=res, shadows=shadows, shadow_map_size=256)),
        device=device)
    reg = Registry()
    r.set_active_registry(reg)
    # texture pool: checkers at several frequencies + hue noise
    for i in range(6):
        if i < 3:
            img = checkerboard(128, 4 << i)
        else:
            img = (rng.random((64, 64, 4)) * 255).astype(np.uint8)
            img[..., 3] = 255
        r.acquire_texture(f"t{i}", img)
    sphere = r.ensure_primitive(PrimitiveType.SPHERE)
    cube = r.ensure_primitive(PrimitiveType.CUBE)
    ents = []
    for i in range(grid):
        for j in range(grid):
            e = reg.create()
            reg.add(e, TransformComponent())
            reg.add(e, MeshComponent(
                mesh_index=sphere if (i + j) % 2 else cube))
            reg.add(e, TextureComponent(path="t0", slot=1))
            ents.append(e)
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(light_type=LightType.DIRECTIONAL,
                                cast_shadows=shadows))
    return r, reg, ents, sun, rng, (spread, scale_range)


def build_pools(res: int, seed: int, device=None) -> list:
    """One pool of each POOL_SPECS entry, seeded seed, seed + 1, …"""
    return [build_pool(res, seed + i, device=device, **spec)
            for i, spec in enumerate(POOL_SPECS)]


def randomize(r, reg, ents, sun, rng, spread=4.5, scale_range=(0.4, 1.4)):
    from trident_tpu_torch.ecs.components import (
        LightComponent, TextureComponent, TransformComponent)

    for e in ents:
        t = reg.get(e, TransformComponent)
        t.position = rng.uniform(-spread, spread, 3).astype(np.float32)
        t.rotation = rng.uniform(0, 360, 3).astype(np.float32)
        t.scale = np.full(3, rng.uniform(*scale_range), np.float32)
        reg.get(e, TextureComponent).slot = int(rng.integers(1, 7))
    lc = reg.get(sun, LightComponent)
    d = rng.normal(size=3)
    d[1] = -abs(d[1]) - 0.3
    lc.direction = (d / np.linalg.norm(d)).astype(np.float32)
    lc.intensity = float(rng.uniform(2.0, 5.0))
    ang = rng.uniform(0, 2 * np.pi)
    dist = rng.uniform(6.0, 11.0)
    r.editor_camera.set_position([np.sin(ang) * dist,
                                  rng.uniform(0.5, 4.0),
                                  np.cos(ang) * dist])
    tgt = rng.uniform(-1, 1, 3)
    r.editor_camera.look_at_target(tgt)
    return tgt


def _view_proj(cam) -> np.ndarray:
    p = cam.host_params()
    return np.asarray(p.proj) @ np.asarray(p.view)


def _rgb(out) -> torch.Tensor:
    """A frame's RGBA8 colour → (H, W, 3) f32 in [0, 1]."""
    return out.color[..., :3].float() / 255.0


def render_sequence_pairs(n_pairs: int, res: int, seed: int,
                          with_depth: bool = False, device=None,
                          pools: Optional[list] = None):
    """Temporal mode: per sample, render the PREVIOUS frame at full res
    from a nearby camera, then orbit a little and render the current
    half-res input + full-res target + half-res depth + both cameras'
    view-projections. The warp input is built with the SAME
    warp_previous the runtime uses, so train == inference. → (inputs
    (N, res/2, res/2, 16|17), targets (N, res, res, 3)) f32 tensors on the
    pools' device; `pools` defaults to build_pools(res, seed, device)."""
    from trident_tpu_torch.ai.upscaler import warp_previous
    from trident_tpu_torch.ecs.components import TransformComponent

    pools = pools or build_pools(res, seed, device)
    dev = pools[0][0].device
    xs, depths, temporals, targets = [], [], [], []
    t0 = time.time()
    for k in range(n_pairs):
        r, reg, ents, sun, rng, (spread, srange) = pools[k % len(pools)]
        tgt = randomize(r, reg, ents, sun, rng, spread, srange)
        cam = r.editor_camera
        # previous frame: full res at pose A
        r.set_viewport(0, res, res)
        prev_rgb = _rgb(r.render_viewport(0))
        prev_vp = _view_proj(cam)
        # frame-to-frame motion: mostly camera (orbit + dolly jitter), but
        # a fraction rotates the OBJECTS under a static camera — the warp
        # is then an identity map with stale content, the history-mismatch
        # case animated scenes hit at runtime
        if rng.random() < 0.3:
            for e in ents:
                t = reg.get(e, TransformComponent)
                t.rotation = t.rotation + rng.uniform(-6, 6, 3).astype(
                    np.float32)
        else:
            cam.orbit(tgt, float(rng.uniform(-4, 4)),
                      float(rng.uniform(-2, 2)))
            cam.dolly(float(rng.uniform(-0.3, 0.3)))
        targets.append(r.render_viewport(0).color[..., :3])
        r.set_viewport(0, res // 2, res // 2)
        cur_out = r.render_viewport(0)
        xs.append(_rgb(cur_out))
        if with_depth:
            depths.append(cur_out.depth[..., None].float())
        vp = _view_proj(cam)
        t_in = warp_previous(
            prev_rgb, cur_out.depth,
            torch.from_numpy(np.linalg.inv(vp).astype(np.float32)).to(dev),
            torch.from_numpy(prev_vp.astype(np.float32)).to(dev), res, res)
        # a fraction trains with NO history (valid=0 → the first-frame /
        # spatial-fallback case the runtime hits after scene edits)
        if rng.random() < 0.2:
            t_in = torch.zeros_like(t_in)
        temporals.append(t_in)
        if (k + 1) % 32 == 0:
            print(f"  rendered {k + 1}/{n_pairs} sequence pairs "
                  f"({time.time() - t0:.0f}s)", flush=True)
    parts = ([torch.stack(xs)] + ([torch.stack(depths)] if with_depth else [])
             + [torch.stack(temporals)])
    return (torch.cat(parts, dim=-1),
            torch.stack(targets).float() / 255.0)


def render_pairs(n_pairs: int, res: int, seed: int, with_depth: bool = False,
                 device=None, pools: Optional[list] = None):
    """→ (inputs (N, res/2, res/2, 3|4), targets (N, res, res, 3)) f32
    tensors on the pools' device; `pools` defaults to build_pools(res,
    seed, device)."""
    pools = pools or build_pools(res, seed, device)
    inputs, targets = [], []
    t0 = time.time()
    for k in range(n_pairs):
        r, reg, ents, sun, rng, (spread, srange) = pools[k % len(pools)]
        randomize(r, reg, ents, sun, rng, spread, srange)
        r.set_viewport(0, res, res)
        targets.append(r.render_viewport(0).color[..., :3])
        r.set_viewport(0, res // 2, res // 2)
        cur_out = r.render_viewport(0)
        rgb = _rgb(cur_out)
        if with_depth:
            rgb = torch.cat([rgb, cur_out.depth[..., None].float()], dim=-1)
        inputs.append(rgb)
        if (k + 1) % 32 == 0:
            print(f"  rendered {k + 1}/{n_pairs} pairs "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return torch.stack(inputs), torch.stack(targets).float() / 255.0


def render_datasets(res_list: List[int], pairs: int, seed: int, *,
                    temporal: bool, depth: bool, device=None,
                    pools: Optional[dict] = None) -> list:
    """One (train inputs, train targets, val inputs, val targets, res) per
    scale: max(pairs // len(res_list), 8) pairs each, the first
    max(per_res // 8, 4) held out. `pools` maps a scale to the pools it
    renders with (default: build_pools at seed + 101·j)."""
    per_res = max(pairs // len(res_list), 8)
    datasets = []
    for j, res in enumerate(res_list):
        print(f"rendering training pairs at {res}px…", flush=True)
        render = render_sequence_pairs if temporal else render_pairs
        inputs, targets = render(per_res, res, seed + 101 * j,
                                 with_depth=depth, device=device,
                                 pools=(pools or {}).get(res))
        n_val = max(per_res // 8, 4)
        datasets.append((inputs[n_val:], targets[n_val:],
                         inputs[:n_val], targets[:n_val], res))
    return datasets


def cosine_decay(steps: int, alpha: float = COSINE_ALPHA):
    """optax.cosine_decay_schedule's factor: update k (from 0) uses
    lr · ((1 − alpha) · ½(1 + cos(π·min(k, steps)/steps)) + alpha)."""
    def factor(k: int) -> float:
        k = min(k, steps)
        return (1 - alpha) * (0.5 * (1 + math.cos(math.pi * k / steps))) \
            + alpha
    return factor


def make_optimizer(net, lr: float, steps: int):
    """(Adam with optax.adam's defaults, its cosine LambdaLR): step the
    scheduler after each optimizer step."""
    from trident_tpu_torch.ai.train import make_optimizer as adam

    opt = adam(net.parameters(), lr)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps))


def upscaler_loss(net, x: torch.Tensor, y: torch.Tensor,
                  edge_weight: float) -> torch.Tensor:
    """L1 of the net's 2× output against the target plus edge_weight × the
    L1 of their x and y image gradients (penalizes blurred detail)."""
    out = net.upscale(x)
    l1 = torch.mean(torch.abs(out - y))
    gx = torch.mean(torch.abs((out[:, :, 1:] - out[:, :, :-1])
                              - (y[:, :, 1:] - y[:, :, :-1])))
    gy = torch.mean(torch.abs((out[:, 1:] - out[:, :-1])
                              - (y[:, 1:] - y[:, :-1])))
    return l1 + edge_weight * (gx + gy)


@torch.no_grad()
def evaluate(net, x: torch.Tensor, y: torch.Tensor):
    """(net PSNR, bilinear PSNR) in dB on one scale's val split."""
    from trident_tpu_torch.ai.upscaler import psnr, resize_bilinear_2x

    return (float(psnr(net.upscale(x), y)),
            float(psnr(resize_bilinear_2x(x[..., :3]), y)))


def eval_all(net, datasets):
    """Mean net / bilinear PSNR across every scale's val split, and the
    per-scale net PSNRs."""
    nets, bases = [], []
    for _tr_i, _tr_t, v_i, v_t, _res in datasets:
        n, b = evaluate(net, v_i, v_t)
        nets.append(n)
        bases.append(b)
    return (sum(nets) / len(nets), sum(bases) / len(bases),
            ["%d:%.2f" % (d[4], n) for d, n in zip(datasets, nets)])


def fit(net, datasets, *, steps: int, batch: int, lr: float,
        edge_weight: float, seed: int, out: str) -> dict:
    """The training loop: per step a batch of `batch` pairs drawn from
    scale s % len(datasets) (numpy default_rng(seed), as the JAX loop
    draws), one Adam step; every EVAL_EVERY steps the val PSNRs, saving
    the best-so-far net to `out`; the final net saved if it beats them.
    Returns {best, net_psnr, bilinear_psnr, step_ms (median CUDA-event ms
    of the training steps on the card, None on the CPU)}."""
    from trident_tpu_torch.ai.upscaler import save_upscaler

    opt, sched = make_optimizer(net, lr, steps)
    rng = np.random.default_rng(seed)
    cuda = next(net.parameters()).is_cuda
    events = []
    t0 = time.time()
    best = -1.0
    net.train()
    for s in range(steps):
        # alternate scales per step: batches stay uniform, the NET trains
        # across all of them
        tr_i, tr_t = datasets[s % len(datasets)][:2]
        idx = torch.from_numpy(rng.integers(0, tr_i.shape[0], batch)).to(
            tr_i.device)
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        loss = upscaler_loss(net, tr_i[idx], tr_t[idx], edge_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        if (s + 1) % EVAL_EVERY == 0:
            net_p, base_p, per_res = eval_all(net, datasets)
            # checkpoint the best-so-far at every eval: a wall-clock kill
            # then costs nothing — the plateau checkpoint is on disk
            mark = ""
            if net_p > best:
                best = net_p
                save_upscaler(net, out)
                mark = " [saved]"
            detail = (" [" + " ".join(per_res) + "]"
                      if len(per_res) > 1 else "")
            print(f"step {s + 1}: L1={loss.item():.4f} "
                  f"val PSNR net={net_p:.2f}dB "
                  f"bilinear={base_p:.2f}dB{detail} "
                  f"({time.time() - t0:.0f}s){mark}", flush=True)

    net_p, base_p, _ = eval_all(net, datasets)
    if net_p > best:
        save_upscaler(net, out)
    step_ms = None
    if cuda:
        torch.cuda.synchronize()
        step_ms = statistics.median(
            a.elapsed_time(b) for a, b in zip(events[::2], events[1::2]))
    print(f"saved {out}: best val PSNR {max(best, net_p):.2f}dB "
          f"vs bilinear={base_p:.2f}dB")
    return {"best": max(best, net_p), "net_psnr": net_p,
            "bilinear_psnr": base_p, "step_ms": step_ms}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=192,
                    help="total rendered pairs (split across --res scales)")
    ap.add_argument("--res", type=str, default="256",
                    help="render resolution(s), comma-separated (e.g. "
                         "'256,128'): multi-scale training fixes the "
                         "out-of-distribution regression at scales the net "
                         "never saw (the conv net itself is size-agnostic; "
                         "batches stay uniform per step, alternating scales)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--edge-weight", type=float, default=0.25,
                    help="extra L1 on image gradients (sharpens edges)")
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temporal", action="store_true",
                    help="train the temporal net: previous full-res frame "
                         "reprojected by depth rides in as 13 extra "
                         "channels (ai/upscaler.py warp_previous)")
    ap.add_argument("--depth", action="store_true",
                    help="feed the half-res G-buffer depth as an extra "
                         "input channel (silhouette edges are unambiguous "
                         "where rgb alone aliases); composes with "
                         "--temporal")
    ap.add_argument("--out", default="assets_out/upscaler_2x")
    ap.add_argument("--init-from", default=None,
                    help="resume/fine-tune from an existing checkpoint dir "
                         "or .npz (channel layout must match the selected "
                         "flags); dataset rendering is the expensive phase, "
                         "so continuing a run costs little extra")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    return ap.parse_args(argv)


def init_net(args, in_channels: int, device):
    """The net to train: --init-from's (its width and input channels
    checked against the run's) or a fresh init_upscaler from --seed."""
    from trident_tpu_torch.ai.upscaler import (
        init_upscaler, load_upscaler, upscaler_in_channels)

    if args.init_from:
        net, bc = load_upscaler(args.init_from, device)
        if bc != args.channels or upscaler_in_channels(net) != in_channels:
            raise SystemExit(
                f"--init-from {args.init_from}: checkpoint is "
                f"{bc}ch/{upscaler_in_channels(net)}-input but the run "
                f"wants {args.channels}ch/{in_channels}-input")
        print(f"resuming from {args.init_from}", flush=True)
        return net.requires_grad_(True)
    return init_upscaler(torch.Generator().manual_seed(args.seed),
                         args.channels, in_channels=in_channels,
                         device=device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    res_list = [int(r) for r in str(args.res).split(",") if r]
    datasets = render_datasets(res_list, args.pairs, args.seed,
                               temporal=args.temporal, depth=args.depth,
                               device=device)
    net = init_net(args, datasets[0][0].shape[-1], device)
    return fit(net, datasets, steps=args.steps, batch=args.batch,
               lr=args.lr, edge_weight=args.edge_weight, seed=args.seed,
               out=args.out)


if __name__ == "__main__":
    main()
