"""The comparison that decides `correct`: frames (and, where the scene
keeps them, animation palettes) the timed path produced, against the
plain reference (benchmark/reference/) at the same step of the traffic.

Numbers, each the largest over the compared frames:
- off3_share: the share of RGBA8 values more than 3 LSB off;
- mean_err: the mean absolute difference, in LSB;
- tile_err: the largest mean absolute difference over 32×32-pixel tiles,
  in LSB (what a local fault moves and scattered rounding does not);
- palette_err: the largest absolute difference of a skinning-matrix
  element (scenes that animate).
Each number that a configuration sets a limit for is held to it; a
configuration limits the numbers its control separates from sound runs.

A frame may take in state from the program's earlier frames: the 2×
upscaled frame warps in its predecessor's history. Its scene declares
that state (`given(prev_out)`), the harness keeps it with the frame's
outputs, and the reference renders the compared step from the same
state. So the comparison is one step at a time: each frame is judged on
what it did with the history it was given. A plain reference cannot
re-render the thousands of frames before a window's last one, and its
own rounded history would drift away from the program's. Each step runs
at full precision, so this loosens nothing: a frame that ignores its
history, or takes a stale one, still parts from the reference's step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

TILE = 32


def frame_numbers(program: torch.Tensor, reference: torch.Tensor) -> dict:
    """off3_share, mean_err and tile_err of an (H, W, 4) uint8 frame
    against the reference's."""
    d = (program.to(torch.int32) - reference.to(torch.int32)).abs().float()
    h, w = d.shape[:2]
    ph, pw = -h % TILE, -w % TILE
    tiles = torch.nn.functional.pad(d.mean(-1), (0, pw, 0, ph))
    tiles = tiles.view((h + ph) // TILE, TILE, (w + pw) // TILE, TILE)
    area = torch.nn.functional.pad(torch.ones((h, w), device=d.device),
                                   (0, pw, 0, ph)).view(tiles.shape)
    tile_mean = tiles.sum((1, 3)) / area.sum((1, 3))
    return {"off3_share": float((d > 3).float().mean()),
            "mean_err": float(d.mean()),
            "tile_err": float(tile_mean.max())}


def palette_numbers(program: list, reference: torch.Tensor) -> dict:
    """palette_err of the program's per-character palettes (a list of
    (B, 4, 4) arrays) against the reference's (N, B, 4, 4)."""
    p = torch.as_tensor(np.stack(program), device=reference.device)
    return {"palette_err": float((p - reference).abs().max())}


class Kept(NamedTuple):
    """A compared frame: the traffic step its reference renders, the
    program's RGBA8 frame, what the scene kept at that step, and the state
    the frame took in from the frames before it (None: nothing)."""

    step: int
    colour: Optional[torch.Tensor]
    outputs: dict
    given: Optional[dict] = None


def compare(scene_cls, cfg: dict, motion, frames: list, device,
            control: bool = False) -> dict:
    """The numbers of `frames` (each a Kept or the tuple of its fields)
    against the reference, each the largest over the frames; the
    reference renders each step from the state that frame was given.
    With `control` the program's frames are ignored and the reference
    computed in TF32, given the same state, stands in the program's place
    (the control of the comparison)."""
    ref = scene_cls.reference
    worst: dict = {}
    for frame in frames:
        k, colour, kept, given = Kept(*frame)
        given = given or {}
        want = ref.reference_frame(cfg, motion, k, device, given=given)
        if control:
            got = ref.reference_frame(cfg, motion, k, device, control=True,
                                      given=given)
            colour = got["color"]
            kept = ({"palettes": list(got["palettes"].cpu().numpy())}
                    if "palettes" in got else {})
        nums = frame_numbers(colour.to(device), want["color"])
        if "palettes" in kept:
            nums.update(palette_numbers(kept["palettes"], want["palettes"]))
        for name, v in nums.items():
            worst[name] = max(worst.get(name, v), v)
        del want
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """(all within limits, {name: {"value", "limit"}}) over the numbers
    the configuration sets a limit for (those its control separates from
    sound runs); a limited number that was not computed fails, and so do
    no limits at all."""
    checks = {n: {"value": numbers.get(n), "limit": lim}
              for n, lim in sorted(limits.items())}
    ok = bool(checks) and all(c["value"] is not None
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
