"""Shared helpers of the benchmark's CPU tests (python3 -m pytest
benchmark/): each cell's configuration cut to a 128² frame that a CPU
renders in seconds, with the configuration's own limits."""

import copy

import pytest

from benchmark import harness

CELLS = ("field1m_1080.dynamic", "crowd144_1080.animated",
         "field1m_1080.offline", "crowd144_1080.offline")


def small_config(cell_name: str, size: int = 128) -> dict:
    """The cell's configuration at size², with a 4² field or a 2² crowd of
    16 × 12-quad tubes, the camera pulled in to match."""
    _c, cfg, _t = harness.cell(cell_name)
    cfg = copy.deepcopy(cfg)
    cfg["width"] = cfg["height"] = size
    if cfg["scene"] == "sphere_field":
        cfg["grid"] = 4
    else:
        cfg["grid"] = 2
        cfg["tube"].update(segments=16, rings=12)
    cfg["camera"]["position"] = [0.0, 0.0, cfg["grid"] * 1.1 + 2.0]
    return cfg


@pytest.fixture
def small():
    return small_config
