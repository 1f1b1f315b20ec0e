"""The port's profiling surface on the CPU: render_frame's ablation stops
(`profile_stop`) against the JAX package's, utils/profiling.py without a
card, and the profile_stages script.

  * profile_stop: every stop's FrameOutput (colour, depth, ids, aux)
    equals the JAX `_render_frame_impl`'s bit for bit on the 3×3 sphere
    grid at 64². The JAX side runs under jit in a child process with
    XLA_FLAGS=--xla_cpu_max_isa=AVX: with FMAs, XLA:CPU moves the
    interpreted visibility kernel's depth by up to 5 ulps (525 of the
    4096 pixels at this size, op by op), without them the depths are
    equal;
  * a stop the route does not have raises ValueError;
  * Profiler writes a Chrome trace with no card, profile_block marks it
    and lets the caller's exception through, compilation_stats sums the
    live frame-graph caches' captures;
  * scripts/profile_stages.py prints every stage line at a small size.
"""

import functools
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from trident_tpu_torch.render import graphs
from trident_tpu_torch.render.renderer import PROFILE_STOPS, render_frame
from trident_tpu_torch.utils import Profiler, compilation_stats, profile_block

from test_torch_frame import _sphere_grid
from test_torch_host import carry_renderer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = 64
FIELDS = ("color", "depth", "tri_id", "aux")


def grid_renderer():
    jr = _sphere_grid()
    jr.config.render.width = jr.config.render.height = SIZE
    jr.editor_camera.set_viewport_size(SIZE, SIZE)
    return jr


def jax_stop_outputs() -> dict:
    """The JAX FrameOutput of every stop (this file as the child)."""
    import jax

    from trident_tpu.render.frame import build_draw_params, gather_mesh_draws
    from trident_tpu.render.lights import gather_lights
    from trident_tpu.render.renderer import _render_frame_impl

    jr = grid_renderer()
    records = gather_mesh_draws(jr.registry, jr.geometry)
    packed = jr.geometry.packed()
    plan, tri_draw = jr._plan_cache.plan(packed, records, jr.geometry.version)
    params, palette, shade = build_draw_params(
        records, plan.num_draws, material_table=jr.geometry.material_table())
    args = (None, plan, tri_draw, params, palette, shade,
            jr.editor_camera.params(), gather_lights(jr.registry),
            jr.textures.device_arrays(), None, None,
            jr._plan_cache.corner_table(packed), None, None)
    out = {}
    for stop in PROFILE_STOPS:
        fo = jax.jit(functools.partial(
            _render_frame_impl, width=SIZE, height=SIZE,
            clear_color=tuple(jr.config.render.clear_color),
            raster="pallas", chunk=64, skinned=False,
            profile_stop=stop))(*args)
        out[stop] = {f: np.asarray(getattr(fo, f)) for f in FIELDS}
    return out


@pytest.fixture(scope="module")
def stops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stops")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(tmp / "j.pkl")],
                          env=env, cwd=tmp, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp / "j.pkl", "rb") as f:
        want = pickle.load(f)
    tr = carry_renderer(grid_renderer())
    tr.editor_camera.set_viewport_size(SIZE, SIZE)
    inp = tr.frame_inputs()
    got = {stop: render_frame(**inp, profile_stop=stop)
           for stop in PROFILE_STOPS}
    return want, got, inp


@pytest.mark.parametrize("stop", PROFILE_STOPS)
def test_profile_stop_equals_jax_bitwise(stops, stop):
    want, got, _inp = stops
    fo = got[stop]
    for f in FIELDS:
        a, b = getattr(fo, f).numpy(), want[stop][f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert (a.view(np.uint8) == b.view(np.uint8)).all(), (stop, f)
    if stop in ("vis", "resolve_tiled", "resolve"):
        assert int((fo.tri_id >= 0).sum()) > 500      # the real G-buffer


def test_stops_a_route_lacks_raise(stops):
    _want, _got, inp = stops
    full = render_frame(**inp)
    assert full.color.shape == (SIZE, SIZE, 4)
    for bad in ("nope", "untile"):
        with pytest.raises(ValueError, match="profile stop"):
            render_frame(**inp, profile_stop=bad)
    with pytest.raises(ValueError, match="profile stop"):
        render_frame(**{**inp, "forward_shading": False}, profile_stop="vis")
    with pytest.raises(ValueError, match="profile stop"):
        render_frame(**{**inp, "corner_t": None}, profile_stop="corner")
    geom = render_frame(**{**inp, "forward_shading": False},
                        profile_stop="geom")
    assert (geom.tri_id == -1).all() and (geom.depth == 1.0).all()


def test_profiler_writes_a_trace_without_a_card(tmp_path):
    p = Profiler(str(tmp_path / "traces"))
    assert p.stop() is None
    assert p.start() and p.start()                  # already active
    with profile_block("trident-test-block"):
        torch.ones(64).mul_(2).sum()
    path = p.stop()
    assert path and os.path.isfile(path) and p.stop() is None
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "trident-test-block" in names


def test_profile_block_passes_the_callers_exception():
    with pytest.raises(KeyError, match="mine"):
        with profile_block("raises"):
            raise KeyError("mine")


def test_compilation_stats_sums_live_graph_captures():
    base = compilation_stats().render_frame_variants
    assert base == sum(g.captures for g in list(graphs.LIVE))

    class Stand:
        captures = 3

    s = Stand()
    graphs.LIVE.add(s)
    try:
        assert compilation_stats().render_frame_variants == base + 3
    finally:
        graphs.LIVE.discard(s)
    assert compilation_stats().render_frame_variants == base


def test_profile_stages_prints_every_stage(capsys):
    from trident_tpu_torch.scripts import profile_stages as ps

    ps.profile(48, 48, 1, "tiny", torch.device("cpu"), n=1)
    out = capsys.readouterr().out
    names = ["vertex", "setup", "bins", "visibility(incl bins)", "planes",
             "deferred[bilinear]", "deferred[nearest]", "resolve records",
             "vis+records+resolve", "deferred_attrs[bilinear]",
             "corner stage (geom+setup+attrs)"]
    names += [f"FULL[{n}]" for n in ("gather", "forward", "forward+corner",
                                      "forward+corner+stride")]
    names += [f"ABLATE[{s}]" for s in PROFILE_STOPS]
    for name in names:
        assert f"  {name}: " in out, name
    assert "--- tiny: tris(pad)=" in out and "aux=[0 0]" in out


if __name__ == "__main__":          # the JAX side, in a child process
    result = jax_stop_outputs()
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
