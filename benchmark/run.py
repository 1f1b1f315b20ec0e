"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer ones
with --trace 1), device, with --trace 1 a breakdown of the traced stretch,
and last the numbers compared with their limits (`checks`), which also end
standard error. Exits non-zero with no result line without a CUDA card,
and if jax, jaxlib, flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "trident_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "build/inductor"}


def forbidden_modules(names=None) -> list:
    """The top-level names among `names` (the loaded modules by default)
    that are in FORBIDDEN, compared whole: trident_tpu_torch is not
    trident_tpu."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(CHECKOUT / rel)

    import torch

    from benchmark import harness

    cell, _cfg, _traffic = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card (torch.cuda.is_available() is "
              "False); nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    harness.log(f"card: {card_line()}")
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
