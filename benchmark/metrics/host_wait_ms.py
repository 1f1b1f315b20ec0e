"""Frame loop: the host's milliseconds per frame blocked on the card, as
the program counts its own waits (trident_tpu_torch/utils/profiling.py:
the spans named wait.<site>: wait.pace, wait.slot, wait.upload,
wait.readback, wait.evict) over the frames it counted, both accrued
while the traced stretch's profiler recorded. Nothing to read when the
program has no tracer, counted no frame, or waited nowhere (a loop that
paces itself on the harness's marks)."""

KIND = "per_layer"
UNIT = "ms/frame"


def from_snapshot(snap: dict):
    waits = [v["seconds"] for k, v in snap.get("spans", {}).items()
             if k.startswith("wait.")]
    if not snap.get("frames") or not waits:
        return None
    return 1e3 * sum(waits) / snap["frames"]


def read(run):
    from trident_tpu_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)
    return None if tracer is None else from_snapshot(tracer.snapshot())
