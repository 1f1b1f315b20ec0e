"""Port binning + visibility vs the JAX package's binned Pallas kernel
(interpret mode) and its O(T·pixels) oracle, on seeded random scenes in
the style of test_raster_pallas_cpu.py.

Tolerances. In a child process whose XLA:CPU may not emit FMAs
(--xla_cpu_max_isa=AVX) the jitted kernel rounds every product and sum
once, as PyTorch's eager ops and the CUDA kernel (-fmad=false) do: winner
ids must then be equal apart from counted ≤1-ulp depth ties, and depths
bit-equal where the ids agree. In this process XLA:CPU contracts the edge
functions a·px + b·py + c into FMAs, so edge values and depths differ in
the last bits, and a winner id may differ only where that rounding
decides: a depth tie (the two depths within 2 ulps) or an edge flip (the
pixel centre within rounding of a triangle edge). Every such mismatch is
classified, and there must be few. The oracle is evaluated op by op; it
divides z/w where the kernels multiply by 1/w, so ids match it exactly
here and depths within 1 ulp.
Run as a script, this file is the child: `python test_torch_raster.py
SETUP.npz WIDTH OUT.npz` runs the kernel on SETUP's triangles.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ops.raster_pallas import visibility_pallas
from trident_tpu.ops.raster_ref import visibility_ref as j_visibility_ref
from trident_tpu.ops.vertex import TriangleSetup as JTriangleSetup
from trident_tpu.ops.vertex import triangle_setup as j_triangle_setup

from trident_tpu_torch.ops import raster
from trident_tpu_torch.ops.raster_ref import visibility_ref
from trident_tpu_torch.render.types import from_numpy

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H = 256, 64
WB = 384


def _setup_from_ndc(pos, w_coord=None, w=W, h=H):
    """(T,3,3) NDC-ish positions (+ optional (T,3) w) → the JAX package's
    TriangleSetup (evaluated op by op) and the port's copy of it."""
    t = pos.shape[0]
    ww = (np.ones((t, 3, 1), np.float32) if w_coord is None
          else np.asarray(w_coord, np.float32)[..., None])
    clip = np.concatenate(
        [pos[..., :2] * ww, (pos[..., 2:3] * 0.5 + 0.5) * ww, ww],
        axis=-1).astype(np.float32)
    with jax.disable_jit():
        js = j_triangle_setup(jnp.asarray(clip.reshape(t * 3, 4)),
                              jnp.arange(t * 3, dtype=jnp.int32).reshape(t, 3),
                              jnp.ones(t, bool), w, h)
    return js, from_numpy(js, "cpu")


def _random_scene(rng, t=200, spread=0.9, size=0.2):
    pos = (rng.uniform(-1, 1, (t, 1, 3)) * [spread, spread, 0.4]
           + rng.uniform(-size, size, (t, 3, 3)))
    ww = np.ones((t, 3), np.float32) * rng.uniform(0.5, 2.0, (t, 1))
    return _setup_from_ndc(pos, ww), W


def _clustered_scene(rng):
    pos = (rng.uniform(-1, -0.6, (640, 1, 3)) * [1, 1, 0]
           + rng.uniform(-0.1, 0.1, (640, 3, 3)) + [0, 0, 0.3])
    return _setup_from_ndc(pos), W


def _near_plane_scene(rng):
    t = 96
    pos = rng.uniform(-0.8, 0.8, (t, 3, 3)).astype(np.float32)
    pos[:, :, 2] = rng.uniform(0.1, 0.9, (t, 3))
    ww = np.ones((t, 3), np.float32)
    ww[:5, 0] = -0.5  # some vertices behind the eye → full-screen bboxes
    return _setup_from_ndc(pos, ww, w=WB), WB


SCENES = {"random": _random_scene, "clustered": _clustered_scene,
          "near_plane": _near_plane_scene}


def _strict_eval(ps, tid, ys, xs):
    """Per (pixel, triangle): (covered, depth, min |e| relative to the
    edge terms) with the kernel's separately rounded arithmetic."""
    e = ps.edge[tid]                                   # (N,3,3)
    px = torch.from_numpy(xs.astype(np.float32) + 0.5)[:, None]
    py = torch.from_numpy(ys.astype(np.float32) + 0.5)[:, None]
    ek = e[:, :, 0] * px + e[:, :, 1] * py + e[:, :, 2]
    mag = (e[:, :, 0] * px).abs() + (e[:, :, 1] * py).abs() + e[:, :, 2].abs()
    z, w = ps.z[tid], ps.w[tid]
    zi = (ek[:, 0] * z[:, 0] + ek[:, 1] * z[:, 1]) + ek[:, 2] * z[:, 2]
    wi = (ek[:, 0] * w[:, 0] + ek[:, 1] * w[:, 1]) + ek[:, 2] * w[:, 2]
    cover = ((ek >= 0).all(1) & (zi >= 0) & (zi <= wi) & (wi > 1e-12)
             & ps.valid[tid])
    rel = (ek.abs() / mag.clamp_min(1e-30)).amin(1)
    return cover, zi * (1.0 / wi), rel


def _classify(ps, port_tri, ref_tri, tie_ulps=2, edge_flips=True):
    """Count id mismatches; assert each is a ≤`tie_ulps` depth tie or, with
    `edge_flips`, an edge flip (a pixel centre within 1e-6 relative of an
    edge)."""
    ys, xs = np.nonzero(port_tri != ref_tri)
    if ys.size == 0:
        return 0
    unexplained = []
    for y, x in zip(ys, xs):
        ids = [int(port_tri[y, x]), int(ref_tri[y, x])]
        cands = [i for i in ids if i >= 0]
        cov, d, rel = _strict_eval(ps, torch.tensor(cands),
                                   np.full(len(cands), y),
                                   np.full(len(cands), x))
        edge = edge_flips and bool((rel < 1e-6).any())
        ulp = np.spacing(np.float32(max(float(d.abs().max()), 1e-30)))
        tie = (len(cands) == 2 and bool(cov.all())
               and abs(float(d[0] - d[1])) <= tie_ulps * ulp)
        if not (edge or tie):
            unexplained.append((y, x, ids, cov.tolist(), d.tolist()))
    assert not unexplained, unexplained[:5]
    return ys.size


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_visibility_matches_pallas_and_oracle(scene):
    (js, ps), w = SCENES[scene](np.random.default_rng(1234))
    port = raster.visibility(ps, w, H)
    pal = jax.jit(lambda s: visibility_pallas(s, w, H, interpret=True))(js)
    with jax.disable_jit():
        ref = j_visibility_ref(js, w, H)
    assert port.aux.tolist() == [0, 0]
    assert np.asarray(pal.aux).tolist() == [0, 0]
    pt, pd = port.tri_id.numpy(), port.depth.numpy()
    covered = int((pt >= 0).sum())
    assert covered > 500

    # vs the oracle (op by op): ids exact, depth within one rounding step
    rt, rd = np.asarray(ref.tri_id), np.asarray(ref.depth)
    assert (pt == rt).all()
    assert (np.abs(pd - rd) <= np.spacing(np.maximum(np.abs(rd), 1e-30))).all()
    # and the port's own torch oracle agrees with the JAX oracle
    tr = visibility_ref(ps, w, H)
    assert (tr.tri_id.numpy() == rt).all()
    assert (tr.depth.numpy() == rd).all()

    # vs the Pallas kernel (jitted, FMA-contracted): classified mismatches
    n_bad = _classify(ps, pt, np.asarray(pal.tri_id))
    assert n_bad <= max(2, covered // 1000), n_bad
    same = pt == np.asarray(pal.tri_id)
    np.testing.assert_allclose(pd[same], np.asarray(pal.depth)[same],
                               rtol=0, atol=2e-5)


def _pallas_without_fma(js, w, tmp_path):
    """visibility_pallas (jitted, interpret mode) on `js` in the no-FMA
    child process → (tri_id, depth, aux) as numpy."""
    src, dst = tmp_path / "setup.npz", tmp_path / "vis.npz"
    np.savez(src, **{f: np.asarray(getattr(js, f)) for f in js._fields})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, str(src), str(w),
                           str(dst)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(dst)
    return out["tri_id"], out["depth"], out["aux"]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_visibility_bitwise_vs_pallas_without_fma(scene, tmp_path):
    (js, ps), w = SCENES[scene](np.random.default_rng(1234))
    pal_tri, pal_depth, pal_aux = _pallas_without_fma(js, w, tmp_path)
    port = raster.visibility(ps, w, H)
    assert port.aux.tolist() == [0, 0] and pal_aux.tolist() == [0, 0]
    pt, pd = port.tri_id.numpy(), port.depth.numpy()
    assert int((pt >= 0).sum()) > 500
    same = pt == pal_tri
    # a mismatch may only be a depth tie within one ulp; none occur here
    n_ties = _classify(ps, pt, pal_tri, tie_ulps=1, edge_flips=False)
    assert n_ties == 0
    assert (pd[same].view(np.int32) == pal_depth[same].view(np.int32)).all()


def test_empty_scene_is_background():
    _js, ps = _setup_from_ndc(np.zeros((4, 3, 3), np.float32))
    g = raster.visibility(ps, W, H)
    assert (g.tri_id == -1).all() and (g.depth == 1.0).all()
    assert g.aux.tolist() == [0, 0]


def _assert_degraded_cleanly(ps, full, part, t):
    """A capacity-limited frame holds, per pixel, background or a real
    triangle no nearer than the full frame's winner — never garbage."""
    ft, fd = full.tri_id.numpy(), full.depth.numpy()
    qt, qd = part.tri_id.numpy(), part.depth.numpy()
    assert ((qt == -1) | ((qt >= 0) & (qt < t))).all()
    assert (qd >= fd).all()
    kept = qt >= 0
    ys, xs = np.nonzero(kept)
    cov, d, _ = _strict_eval(ps, torch.from_numpy(qt[kept]).long(), ys, xs)
    assert bool(cov.all())
    assert (d.numpy() == qd[kept]).all()
    return int((qt != ft).sum())


def test_pool_overflow_drops_counted_chunks():
    """Near-plane triangles claim every tile; a pool too small for them
    drops the tail sub-blocks' tiles and counts their chunks in aux[1]."""
    rng = np.random.default_rng(7)
    t = raster.CHUNK * 5
    pos = rng.uniform(-0.8, 0.8, (t, 3, 3)).astype(np.float32)
    pos[:, :, 2] = rng.uniform(0.1, 0.9, (t, 3))
    ww = np.ones((t, 3), np.float32)
    ww[::raster.CHUNK, 0] = -0.5     # one full-screen triangle per chunk
    _js, ps = _setup_from_ndc(pos, ww, w=WB)
    full = raster.visibility(ps, WB, H)
    assert full.aux.tolist() == [0, 0]
    part = raster.visibility(ps, WB, H, pool=200)
    aux = part.aux.tolist()
    assert aux[0] == 0 and aux[1] >= 1
    assert _assert_degraded_cleanly(ps, full, part, t) > 0


def test_pair_budget_truncation_is_counted():
    (_js, ps), w = _random_scene(np.random.default_rng(3), t=256,
                                 spread=0.95, size=0.3)
    full_bins = raster.build_bins(ps, w, H)
    n_real = int(full_bins.n_real)
    assert n_real > 8
    full = raster.visibility(ps, w, H)
    part = raster.visibility(ps, w, H, pair_budget=n_real - 5)
    assert part.aux.tolist() == [5, 0]
    assert _assert_degraded_cleanly(ps, full, part, 256) > 0
    # the truncation is deterministic
    again = raster.visibility(ps, w, H, pair_budget=n_real - 5)
    assert (again.tri_id == part.tri_id).all()


def test_bins_cover_every_covering_triangle():
    """Every (tile, triangle) the oracle needs is in some kept pair's hit
    sub-block — the binning is conservative."""
    (_js, ps), w = _random_scene(np.random.default_rng(11), t=300)
    b = raster.build_bins(ps, w, H)
    ref = visibility_ref(ps, w, H)
    ntx = -(-w // raster.TILE)
    tri = ref.tri_id.numpy()
    ys, xs = np.nonzero(tri >= 0)
    need = set(zip(((ys // raster.TILE) * ntx + xs // raster.TILE).tolist(),
                   (tri[ys, xs] // raster.SUB).tolist()))
    have = set()
    n = int(b.n_real)
    for tile, chunk, mask in zip(b.pair_tile[:n].tolist(),
                                 b.pair_chunk[:n].tolist(),
                                 b.pair_mask[:n].tolist()):
        for q in range(raster.NSUB):
            if mask >> q & 1:
                have.add((tile, chunk * raster.NSUB + q))
    assert need <= have
    starts = b.tile_start.tolist()
    assert starts[0] == 0 and starts[-1] == n
    assert (np.diff(starts) >= 0).all()


if __name__ == "__main__":
    setup_npz, width, out_npz = sys.argv[1:]
    arrays = np.load(setup_npz)
    setup = JTriangleSetup(**{f: jnp.asarray(arrays[f])
                              for f in JTriangleSetup._fields})
    g = jax.jit(lambda s: visibility_pallas(s, int(width), H,
                                            interpret=True))(setup)
    np.savez(out_npz, tri_id=np.asarray(g.tri_id),
             depth=np.asarray(g.depth), aux=np.asarray(g.aux))
