"""The comparison that decides `correct`: frames, and the arrays a scene
keeps at each step (the crowd's animation palettes), that the timed path
produced, against the plain reference (benchmark/reference/) at the same
step of the traffic.

Numbers, each the largest over the compared frames:
- off3_share: the share of RGBA8 values more than 3 LSB off;
- mean_err: the mean absolute difference, in LSB;
- tile_err: the largest mean absolute difference over 32×32-pixel tiles,
  in LSB (what a local fault moves and scattered rounding does not);
- <name>_err, for each array the scene keeps: the largest absolute
  difference of an element, in the array's units (LSB for uint8); the
  crowd's palettes keep their older name, palette_err;
- <name>_diff_share, for each kept array of integers: the share of its
  elements that differ at all.
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

A frame may also be judged stage by stage, each stage on the program's own
input. A scene names the arrays it keeps at each step (`KEPT`, read by
`kept(k)`); a reference whose `reference_frame` takes `kept` is handed the
program's kept arrays of that step, computes each stage from the
program's output of the stage before it, and returns its own array under
each kept name. So a stage is held to its own precision: the upscaled
field's net is compared element by element with the reference's net run
on the very colour the program's net read, where a comparison of whole
frames would see only the raster's differences. Every kept array is
compared with the reference's own: an input taken from the program that
went unchecked itself would let a fault hide, so a kept array the
reference does not return raises.
"""

from __future__ import annotations

import inspect
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


# kept arrays whose numbers keep the name they had before every kept array
# was compared alike
NUMBER_NAMES = {"palettes": "palette"}


def kept_numbers(name: str, program, reference: torch.Tensor) -> dict:
    """<name>_err, and for integers <name>_diff_share, of a kept array (a
    tensor, or a list of arrays stacked along a new first axis) against
    the reference's array of that name, which has its shape and kind."""
    if isinstance(program, (list, tuple)):
        program = np.stack(program)
    p = torch.as_tensor(program, device=reference.device)
    if p.shape != reference.shape or (p.is_floating_point()
                                      != reference.is_floating_point()):
        raise ValueError(f"kept {name!r}: {p.dtype} {tuple(p.shape)} "
                         f"against the reference's {reference.dtype} "
                         f"{tuple(reference.shape)}")
    prefix = NUMBER_NAMES.get(name, name)
    if p.is_floating_point():
        return {f"{prefix}_err": float((p - reference).abs().max())}
    d = (p.to(torch.int64) - reference.to(torch.int64)).abs()
    return {f"{prefix}_err": float(d.max()),
            f"{prefix}_diff_share": float((d != 0).float().mean())}


def takes_kept(reference) -> bool:
    """Whether a reference module steps its stages from the program's kept
    arrays: its `reference_frame` takes `kept`."""
    return "kept" in inspect.signature(reference.reference_frame).parameters


class Kept(NamedTuple):
    """A compared frame: the traffic step its reference renders, the
    program's RGBA8 frame, the arrays the scene kept at that step, and the
    state the frame took in from the frames before it (None: nothing)."""

    step: int
    colour: Optional[torch.Tensor]
    outputs: dict
    given: Optional[dict] = None


def compare(scene_cls, cfg: dict, motion, frames: list, device,
            control: bool = False) -> dict:
    """The numbers of `frames` (each a Kept or the tuple of its fields)
    against the reference, each the largest over the frames; the
    reference renders each step from the state that frame was given, and
    a reference that takes `kept` computes each stage from the program's
    kept arrays of that step. Each frame keeps the arrays its scene
    names (`KEPT`); one that the reference does not return raises.
    With `control` the program's frame and kept arrays are ignored (only
    their names are read, and the arrays where the reference takes them)
    and the reference computed in TF32, given the same state and arrays,
    stands in the program's place (the control of the comparison)."""
    ref = scene_cls.reference
    names = set(getattr(scene_cls, "KEPT", ()))
    stages = takes_kept(ref)
    worst: dict = {}
    for frame in frames:
        k, colour, kept, given = Kept(*frame)
        if set(kept) != names:
            raise ValueError(f"{scene_cls.__name__} kept {sorted(kept)} at "
                             f"step {k}; its KEPT names {sorted(names)}")
        inputs = {"given": given or {}}
        if stages:
            inputs["kept"] = kept
        want = ref.reference_frame(cfg, motion, k, device, **inputs)
        missing = sorted(set(kept) - set(want))
        if missing:
            raise ValueError(f"kept {missing}: the reference returns no "
                             "array of that name to compare it with")
        if control:
            got = ref.reference_frame(cfg, motion, k, device, control=True,
                                      **inputs)
            colour, kept = got["color"], {n: got[n] for n in kept}
        nums = frame_numbers(colour.to(device), want["color"])
        for name in sorted(kept):
            nums.update(kept_numbers(name, kept[name], want[name]))
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
