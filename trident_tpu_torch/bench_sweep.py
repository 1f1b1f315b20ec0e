"""Run the port's bench for several configs in one process.

    python3 -m trident_tpu_torch.bench_sweep [--device cpu] [NAME[:ai] ...]

The counterpart of scripts/bench_sweep.py: one JSON line per entry, each
as trident_tpu_torch.bench prints it; the ":ai" suffix measures that
entry's NAME:ai mode (BENCH_AI=1), and "interp" the interpolation net.
The default is bench_sweep.py's five configs. An entry that fails prints
its `bench_error_<entry>` line and the sweep goes on. BENCH_ITERS and the
checkpoint variables apply to every entry.

scripts/bench_sweep.py resets the JAX package's kernel-knob globals
before each entry so that one config's policy cannot leak into the next;
the port has no such globals (each Renderer carries its own knobs and no
environment knob is read), so there is nothing to reset.
"""

from __future__ import annotations

import argparse
import gc
import json
import traceback

import torch

from trident_tpu_torch.bench import arm_watchdog, run, settings_from_env

CONFIGS = ["cube512", "spheres1080", "spheres1080_1m", "ultra4k",
           "shadows1080"]


def error_line(entry: str, error: str) -> dict:
    return {"metric": f"bench_error_{entry}", "value": 0, "unit": "none",
            "vs_baseline": 0, "extra": {"error": error}}


def sweep(entries, device=None, on_bench=None, settings=None) -> list:
    """Each NAME[:ai] entry's JSON line, printed as it completes, in a
    list. `on_bench(entry, bench)` sees each render entry's FrameBench
    after its measurement (bench.run)."""
    settings = settings_from_env() if settings is None else settings
    lines = []
    for entry in entries:
        name, _, mode = entry.partition(":")
        watchdog = arm_watchdog()
        try:
            line = run(name, mode == "ai", device, on_bench=(
                None if on_bench is None
                else lambda b, entry=entry: on_bench(entry, b)), **settings)
        except SystemExit as exc:         # check_aux overflow / bad config
            line = error_line(entry, str(exc))
        except Exception as exc:          # e.g. a checkpoint that won't load
            # one failing entry must not abort the sweep
            traceback.print_exc()
            line = error_line(entry, f"{type(exc).__name__}: {exc}")
        finally:
            if watchdog is not None:
                watchdog.cancel()
            gc.collect()                  # the entry's Renderer and graphs
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("entries", nargs="*", default=CONFIGS,
                        help="NAME[:ai] entries (default: the five configs)")
    args = parser.parse_args(argv)
    sweep(args.entries, args.device)


if __name__ == "__main__":
    main()
