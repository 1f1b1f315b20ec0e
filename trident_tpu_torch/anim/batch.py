"""Batched clip sampling: all instances of a (skeleton, clip) in one call.

Port of trident_tpu/anim/batch.py. The per-entity path (anim/player.py)
walks entities in host Python with numpy poses — parity-correct, but a
scene with hundreds of skinned entities serializes on the host (reference
cost model: ECS/Components/AnimationSystem.cpp:120-165 is a per-entity loop
too, but each iteration there is microseconds of C++).

This module bakes a clip's keyframe tracks into PADDED tables once
(keyframe counts vary per bone), moves them to the sampler's device, and
evaluates all N instance times in one call:

  times (N,) → track sample (N,B) lerp/slerp → local TRS matrices →
  hierarchy walk (a loop over the topo order) → × inverse bind →
  (N,B,4,4) palettes.

The sampler runs on the device it is given and raises if it cannot; it
does not pin itself to the CPU as the JAX sampler does. Unlike the JAX
sampler it does not pad N to a power of two: that padding only spared XLA
a retrace, and eager torch has none.

AnimationSystem groups playing entities by (skeleton, clip) and uses this
path for every group; the state-machine path stays per-entity (its
transition logic is host-side by design).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from trident_tpu_torch import resolve_device
from trident_tpu_torch.anim.data import AnimationClip, Skeleton
from trident_tpu_torch.anim.pose import Pose
from trident_tpu_torch.mathx.quat import quat_normalize, quat_slerp, quat_to_mat3
from trident_tpu_torch.utils.profiling import TRACER

_FAR = 1e30  # finite "+inf" pad keeps (t - t_lo) / (pad - t_lo) == 0 exact


def _pad_track(times: np.ndarray, values: np.ndarray, default: np.ndarray,
               kp: int) -> Tuple[np.ndarray, np.ndarray]:
    """(K,)/(K,C) → (kp,)/(kp,C): empty tracks become a constant `default`
    track; the tail pads with _FAR times + repeated last value so sampling
    at t ≥ last key lands exactly on the last real value."""
    k = len(times)
    c = values.shape[-1] if values.ndim > 1 else default.shape[-1]
    t_out = np.full(kp, _FAR, np.float32)
    v_out = np.zeros((kp, c), np.float32)
    if k == 0:
        t_out[0] = 0.0
        v_out[:] = default
    else:
        t_out[:k] = times
        v_out[:k] = values
        v_out[k:] = values[-1]
    return t_out, v_out


class BatchedClipSampler:
    """Bakes one (clip, skeleton) into padded tables on `device` (the card
    when None); evaluates all instance times in one call. Build once per
    (pair, device) (cached by AnimationSystem)."""

    def __init__(self, clip: AnimationClip, skeleton: Skeleton,
                 device=None) -> None:
        self.clip = clip
        self.skeleton = skeleton
        self.device = resolve_device(device)
        b = len(skeleton)
        bind = Pose.bind(skeleton)
        chans = clip.channel_for(skeleton)

        def kp_for(attr_times) -> int:
            m = max((len(attr_times(ch)) for ch in chans.values()),
                    default=1)
            return max(m, 2)  # ≥2 so the sampling window always exists

        kp_p = kp_for(lambda ch: ch.position_times)
        kp_r = kp_for(lambda ch: ch.rotation_times)
        kp_s = kp_for(lambda ch: ch.scale_times)

        pt = np.zeros((b, kp_p), np.float32)
        pv = np.zeros((b, kp_p, 3), np.float32)
        rt = np.zeros((b, kp_r), np.float32)
        rv = np.zeros((b, kp_r, 4), np.float32)
        st = np.zeros((b, kp_s), np.float32)
        sv = np.zeros((b, kp_s, 3), np.float32)
        for i in range(b):
            ch = chans.get(i)
            e = np.zeros(0, np.float32)
            pt[i], pv[i] = _pad_track(
                ch.position_times if ch else e, ch.positions if ch else e,
                bind.position[i], kp_p)
            rt[i], rv[i] = _pad_track(
                ch.rotation_times if ch else e, ch.rotations if ch else e,
                bind.rotation[i], kp_r)
            st[i], sv[i] = _pad_track(
                ch.scale_times if ch else e, ch.scales if ch else e,
                bind.scale[i], kp_s)

        # (bone, parent) pairs in parent-before-child order
        self._walk = [(i, skeleton.bones[i].parent)
                      for i in skeleton.topo_order()]
        inv_bind = np.stack([bone.inverse_bind for bone in skeleton.bones])
        self._tables = {
            name: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                self.device)
            for name, a in dict(pt=pt, pv=pv, rt=rt, rv=rv, st=st, sv=sv,
                                inv_bind=inv_bind).items()}

    def __call__(self, times: np.ndarray) -> np.ndarray:
        """times: (N,) seconds, already wrapped to the clip duration
        (loop/clamp policy is per-entity host state) → (N,B,4,4) f32 numpy
        (palettes are consumed on the host: one device-to-host copy). The
        times go up in a copy from pageable memory, which waits for the
        work queued on the stream before it. Traced as the spans
        `anim.sample` (the upload, its wait `wait.upload`, and the
        launches) and `anim.readback` (the copy, also the wait
        `wait.readback`), utils/profiling.py."""
        with TRACER.span("anim.sample"):
            t = torch.from_numpy(np.asarray(times, np.float32).reshape(-1))
            with TRACER.span("wait.upload"):
                t = t.to(self.device)
            out = _sample_palettes(self._tables, self._walk, t)
        with TRACER.span("anim.readback"), TRACER.span("wait.readback"):
            host = out.cpu()
        return host.numpy()


def _track(times_tab: torch.Tensor, vals_tab: torch.Tensor, t: torch.Tensor):
    """times_tab (B,K), vals_tab (B,K,C), t (N,) → (v_lo, v_hi, f): the
    (N,B,C) bracketing values and the (N,B) lerp fraction (rotations need
    the raw pair for slerp, so the lerp itself happens at the caller)."""
    b, k = times_tab.shape
    # hi: first key strictly after t, clamped into the padded window
    hi = torch.searchsorted(times_tab, t.expand(b, -1).contiguous(),
                            right=True).clamp(1, k - 1)       # (B,N)
    hi = hi.T                                                 # (N,B)
    lo = hi - 1
    bix = torch.arange(b, device=t.device)[None, :]
    t_lo = times_tab[bix, lo]
    t_hi = times_tab[bix, hi]
    span = torch.clamp_min(t_hi - t_lo, 1e-9)
    f = torch.clamp((t[:, None] - t_lo) / span, 0.0, 1.0)    # (N,B)
    v_lo = vals_tab[bix, lo]                                  # (N,B,C)
    v_hi = vals_tab[bix, hi]
    return v_lo, v_hi, f


def _sample_palettes(tables: Dict[str, torch.Tensor], walk,
                     times: torch.Tensor) -> torch.Tensor:
    """(N,) wrapped times → (N,B,4,4) skinning palettes."""
    p_lo, p_hi, pf = _track(tables["pt"], tables["pv"], times)
    pos = p_lo + (p_hi - p_lo) * pf[..., None]
    s_lo, s_hi, sf = _track(tables["st"], tables["sv"], times)
    scl = s_lo + (s_hi - s_lo) * sf[..., None]
    r_lo, r_hi, rf = _track(tables["rt"], tables["rv"], times)
    rot = quat_slerp(r_lo, r_hi, rf)

    # local TRS matrices (N,B,4,4)
    n, b = pos.shape[:2]
    rot3 = quat_to_mat3(quat_normalize(rot))                  # (N,B,3,3)
    local = torch.zeros((n, b, 4, 4), dtype=torch.float32, device=times.device)
    local[..., :3, :3] = rot3 * scl[..., None, :]
    local[..., :3, 3] = pos
    local[..., 3, 3] = 1.0

    # hierarchy walk local→global in topo order: one (N,4,4) product per
    # bone with a parent (a root's global matrix is its local one)
    global_m = [None] * b
    for idx, parent in walk:
        li = local[:, idx]
        global_m[idx] = li if parent < 0 else torch.matmul(global_m[parent], li)
    return torch.matmul(torch.stack(global_m, dim=1), tables["inv_bind"][None])
