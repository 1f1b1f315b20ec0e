"""A traced stretch's device records split by the program's stage marks.

The program launches a one-thread kernel named `stage_mark_<stage>` at the
start of each stage of a frame (trident_tpu_torch/csrc/stage_mark.cu):
frame, geometry, shadow, binning, visibility, resolve, shading, post, and
`end` after the frame's last work, inside the replayed graph too. A device
record belongs to the stage whose mark last started before it; records
after an `end` mark and before the next frame's marks (staging copies,
output clones, the animation sampler's kernels) belong to no stage, nor
do the marks themselves. A stretch of a program without marks splits
into nothing (None).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Optional

from benchmark import trace

MARK = re.compile(r"(?<!\w)stage_mark_([a-z]+)(?!\w)")
END = "end"


def mark_of(record_name: str) -> Optional[str]:
    """The stage a mark's device record starts, or None for other
    records."""
    m = MARK.search(record_name)
    return None if m is None else m.group(1)


def assign(records) -> Optional[list]:
    """(stage or None, record) for each record that is not a mark, in
    start order; None when the records hold no mark."""
    out, stage, marked = [], None, False
    for r in sorted(records, key=lambda r: r.start_us):
        m = mark_of(r.name)
        if m is not None:
            marked = True
            stage = None if m == END else m
            continue
        out.append((stage, r))
    return out if marked else None


def split_us(records) -> Optional[dict]:
    """Summed µs of device records per stage, and the set of stages whose
    mark appears; None when the records hold no mark."""
    got = assign(records)
    if got is None:
        return None
    sums = defaultdict(float)
    for stage, r in got:
        if stage is not None:
            sums[stage] += r.end_us - r.start_us
    marks = {mark_of(r.name) for r in records} - {None}
    return {s: sums.get(s, 0.0) for s in marks if s != END}


def stage_ms(stretch, stage: str) -> Optional[float]:
    """Device ms per frame of one stage in a stretch: None without a
    stretch or without that stage's mark in it."""
    if stretch is None:
        return None
    per = split_us(stretch.device)
    if per is None or stage not in per:
        return None
    return per[stage] / 1e3 / stretch.frames


def inside_share(records) -> Optional[float]:
    """The share of the device's busy time (the union of the records'
    intervals) that records inside a frame's marks cover, marks included;
    None when the records hold no mark."""
    got = assign(records)
    if got is None:
        return None
    inside = [r for stage, r in got if stage is not None]
    inside += [r for r in records if mark_of(r.name) is not None]
    total, _f, _l = trace.busy_union(records)
    return trace.busy_union(inside)[0] / total if total else None
