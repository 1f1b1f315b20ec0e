"""The control of the comparison, at a cell's own size: the plain
reference computed in TF32 (the nearest precision below the float32 with
TF32 off that the configurations state) put in the program's place, on
the frames a run of each seed would compare. Its numbers are the upper
readings the limits are set below.

Where the configuration's frames take in nothing from the program, it
does not run the program. Where they do, that comes from one run of the
program at the cell's own size and load, a window of WINDOW_S seconds:
the state a frame took in from earlier frames (the scene declares
`given`, as the 2× upscaled frame does with its predecessor's history),
and the arrays the scene kept at each step where the reference computes
each stage from the program's output of the stage before (its
`reference_frame` takes `kept`, check.py). Each frame that run compares,
its last one too, is stepped by the TF32 reference and by the float32
reference, both given the same state and kept arrays; the TF32 one's
stages stand in for the program's (harness.run_cell with `control`).

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed: {"seed", "numbers"}.
"""

from __future__ import annotations

import argparse
import json
import sys

# the program's window where the frames take given state: long enough to
# hold the harness's SAMPLE_SPAN frames, among which the samples are drawn
WINDOW_S = 5.0


def frames(traffic: dict, seed: int) -> list:
    """The reference steps a run of `seed` compares, its last frame
    aside (that one depends on how many frames the window held)."""
    from benchmark import harness

    loop = harness.loop_class(traffic)
    return [loop.ref_step(harness.WARMUP + n, traffic)
            for n in sorted(harness.sample_frames(seed))]


def control_numbers(name: str, seed: int, device, config=None,
                    seconds: float = WINDOW_S) -> dict:
    """The control's numbers for one seed; where the frames take given
    state or the reference steps from kept arrays, from a run of the
    program of `seconds`. Otherwise no program runs: the frames carry only
    the names of the arrays the scene keeps, which the control fills."""
    from benchmark import check, harness
    from benchmark.loops import takes_given

    _c, cfg, traffic = harness.cell(name)
    cfg = config or cfg
    cls = harness.scene_class(cfg)
    if takes_given(cls) or check.takes_kept(cls.reference):
        return harness.run_cell(name, seed, seconds, False, device,
                                config=config, control=True)["numbers"]
    motion = cls.motion_of(cfg, seed, traffic["cycle"])
    names = dict.fromkeys(getattr(cls, "KEPT", ()))
    return check.compare(cls, cfg, motion,
                         [(k, None, names) for k in frames(traffic, seed)],
                         device, control=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program", type=float, default=0.0, metavar="SECONDS",
                   help="read the program's numbers instead (the lower "
                        "readings): one run of that window per seed, all "
                        "in this process")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    for seed in args.seeds:
        if args.program:
            out = harness.run_cell(args.workload, seed, args.program, False,
                                   dev)
            nums = {k: v["value"] for k, v in out["checks"].items()}
            line = {"seed": seed, "numbers": nums, "failed": out["failed"],
                    "attempted": out["attempted"]}
        else:
            line = {"seed": seed,
                    "numbers": control_numbers(args.workload, seed, dev)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
