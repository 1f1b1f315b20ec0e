"""How a traffic mix drives frames. Each loop is a module of its own,
benchmark/loops/<name>.py with its class `LOOP`, found by the name in a
traffic file's "loop" key; a loop has its set-up (warm-up included) and
runs one frame at a time. Frame k of a run (set-up's warm-up frames
included) is the frame after the scene's step k.

A scene whose frames take in state from the frames before them (the 2×
upscaled frame warps its predecessor's history) declares it with
`given(prev_out)`: the state that the frame after `prev_out` took in, as
references to `prev_out`'s tensors (no copy, no launch).

This module holds what the loops share: the frame completion marks, a
frame's drop counters, which scenes take given state, and the base class.
"""

from __future__ import annotations

import time

import torch


class Clock:
    """Frame completion marks: CUDA events on the card (each recorded on
    the current stream after the frame's last work), the host clock after
    the frame's synchronous work on the CPU."""

    def __init__(self, device) -> None:
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def frame_aux(out) -> torch.Tensor:
    """A frame's drop counters (2,): truncated pairs, dropped chunks (the
    light pass's added in)."""
    return out.aux if out.shadow_aux is None else out.aux + out.shadow_aux


def takes_given(scene) -> bool:
    """Whether a scene (or its class) declares `given`: its frames take
    in state from the frames before them."""
    return callable(getattr(scene, "given", None))


class Loop:
    """A traffic mix's loop over a scene. `throttle` is how many frames
    the harness lets stand queued on the card (0: the loop paces itself);
    `submit` names the frame graphs' entry point the loop calls; `last` is
    the output of set-up's last frame, the window's first predecessor."""

    throttle = 0
    submit = "run"
    last = None

    def __init__(self, scene, traffic: dict) -> None:
        self.scene = scene
        self.traffic = traffic

    @staticmethod
    def ref_step(k: int, traffic: dict) -> int:
        """The traffic step whose reference frame k is compared
        with."""
        return k

    def ref_index(self, k: int) -> int:
        return self.ref_step(k, self.traffic)

    def given(self, prev) -> dict:
        """The state the frame after output `prev` took in from it, as the
        scene declares it; {} for a scene that declares none."""
        return self.scene.given(prev) if takes_given(self.scene) else {}

    def launch_list(self) -> dict:
        """The hand-written kernels' launches per replay of the frame graph
        replayed last ({} without graphs)."""
        g = self.scene.renderer.graphs
        return {} if g is None else dict(g.last_launches)

    def span_targets(self) -> list:
        """(object, method, span, drain) of the layers' entry points that
        a traced run times: host frame state, the frame graphs' submit,
        and the scene's own (its animation)."""
        r = self.scene.renderer
        out = [(r, "frame_bundle", "host_state", False)]
        if r.graphs is not None:
            out.append((r.graphs, self.submit, "submit", False))
        return out + self.scene.span_targets()
