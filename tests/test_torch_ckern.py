"""The port's compact-bank visibility (the `ckern` knob) against the JAX
package's CKERN kernel (`_visibility_kernel_ck`, interpret mode) and the
port's own default visibility, on test_torch_raster.py's seeded scenes and
a 600-triangle one (several chunks, varied hit counts per pair).

Tolerances, as test_torch_raster.py states them for the default kernel:
in this process XLA:CPU contracts the JAX kernel's edge functions into
FMAs, so winner ids may differ only at classified depth ties (≤ 2 ulps)
or edge flips, depths within 2e-5 where ids agree; in a child process
whose XLA:CPU may not emit FMAs (--xla_cpu_max_isa=AVX) ids are equal
apart from ≤ 1-ulp ties (none occur) and depths bit-equal. Against the
port's default visibility (the same per-op rounding) the ckern result is
bit-equal. The JAX side runs with `kernel_knobs.overrides(ckern=True,
dynhit=False)`, which restores the knobs afterwards.
Run as a script, this file is the child: `python test_torch_ckern.py
OUT.npz [NAME SETUP.npz WIDTH]...` runs the CKERN kernel on each setup.
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

from trident_tpu.ops import kernel_knobs as jknobs
from trident_tpu.ops.raster_pallas import visibility_pallas
from trident_tpu.ops.vertex import TriangleSetup as JTriangleSetup

from trident_tpu_torch.ops import raster
from trident_tpu_torch.ops.vertex import TriangleSetup
from trident_tpu_torch.render.types import GBuffer

from test_torch_raster import H, SCENES, _classify, _random_scene

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANK = 8
CK_SCENES = dict(SCENES, many_chunks=lambda rng: _random_scene(
    rng, t=600, spread=0.95, size=0.25))


def _scene(name):
    return CK_SCENES[name](np.random.default_rng(1234))


def _port_ckern(ps, w, ck_bank=BANK, **bin_kw):
    """(tri, depth, aux, bins) of the port's ckern path at (w, H)."""
    ntx, nty = -(-w // raster.TILE), -(-H // raster.TILE)
    bins = raster.build_bins(ps, w, H, ck_bank=ck_bank, **bin_kw)
    depth, tri = raster.visibility_ck_tiles(bins, ntx, ntx * nty, ck_bank)
    untile = lambda a: raster.untile_frame(a, ntx, nty)[:H, :w]  # noqa: E731
    return untile(tri).numpy(), untile(depth).numpy(), bins.aux, bins


def _jax_ckern(js, w):
    with jknobs.overrides(ckern=True, dynhit=False):
        g = jax.jit(lambda s: visibility_pallas(s, w, H, interpret=True))(js)
        return np.asarray(g.tri_id), np.asarray(g.depth), np.asarray(g.aux)


@pytest.mark.parametrize("scene", sorted(CK_SCENES))
def test_ckern_matches_jax_ckern_and_default(scene):
    (js, ps), w = _scene(scene)
    pt, pd, aux, _bins = _port_ckern(ps, w)
    assert aux.tolist() == [0, 0]
    covered = int((pt >= 0).sum())
    assert covered > 500
    # the port's default visibility: bit-equal
    ref = raster.visibility(ps, w, H)
    assert (pt == ref.tri_id.numpy()).all()
    assert (pd.view(np.int32) == ref.depth.numpy().view(np.int32)).all()
    # the JAX CKERN kernel (jitted, FMA-contracted): classified mismatches
    jt, jd, jaux = _jax_ckern(js, w)
    assert jaux.tolist() == [0, 0]
    n_bad = _classify(ps, pt, jt)
    assert n_bad <= max(2, covered // 1000), n_bad
    same = pt == jt
    np.testing.assert_allclose(pd[same], jd[same], rtol=0, atol=2e-5)


def test_ckern_bitwise_vs_jax_without_fma(tmp_path):
    args = [str(tmp_path / "out.npz")]
    scenes = {}
    for name in sorted(CK_SCENES):
        (js, ps), w = _scene(name)
        scenes[name] = (ps, w)
        np.savez(tmp_path / f"{name}.npz",
                 **{f: np.asarray(getattr(js, f)) for f in js._fields})
        args += [name, str(tmp_path / f"{name}.npz"), str(w)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, *args], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(args[0])
    for name, (ps, w) in scenes.items():
        pt, pd, _aux, _b = _port_ckern(ps, w)
        jt, jd = out[f"{name}_tri"], out[f"{name}_depth"]
        n_ties = _classify(ps, pt, jt, tie_ulps=1, edge_flips=False)
        assert n_ties == 0, name
        assert (pd.view(np.int32) == jd.view(np.int32)).all(), name


def test_bank_table_contents():
    """Per kept pair: its hit sub-blocks' rows in ascending q, then copies
    of the first hit up to nbank slots, every row's global triangle id in
    column 15, nhit = the mask's popcount; padding pairs have nhit 0."""
    (_js, ps), w = _scene("many_chunks")
    for ck_bank, nbank in ((8, 16), (5, 20), (16, 16)):
        bins = raster.build_bins(ps, w, H, ck_bank=ck_bank)
        n = int(bins.n_real)
        assert bins.banks.shape == (bins.pair_mask.shape[0],
                                    nbank * raster.SUB, raster.REC)
        rec = bins.records.numpy()
        banks = bins.banks.numpy().reshape(-1, nbank, raster.SUB, raster.REC)
        for p in range(bins.pair_mask.shape[0]):
            mask = int(bins.pair_mask[p])
            qs = [q for q in range(raster.NSUB) if mask >> q & 1]
            assert int(bins.nhit[p]) == len(qs)
            if p >= n:
                assert not qs
                continue
            subs = qs + [qs[0]] * (nbank - len(qs))
            for slot, q in enumerate(subs):
                base = int(bins.pair_chunk[p]) * raster.CHUNK + q * raster.SUB
                rows = banks[p, slot]
                assert (rows[:, :15] == rec[base:base + raster.SUB, :15]).all()
                assert (rows[:, 15] == np.arange(base, base + raster.SUB)).all()
        # every bank size renders the same frame
        assert (_port_ckern(ps, w, ck_bank)[0]
                == raster.visibility(ps, w, H).tri_id.numpy()).all()


def test_pair_budget_overflow_is_counted():
    """Pairs past the compact-bank budget are dropped and counted in
    aux[0]; the frame degrades to background or farther real triangles,
    never garbage (test_torch_raster.py's pair-budget check)."""
    from test_torch_raster import _assert_degraded_cleanly

    (_js, ps), w = _scene("many_chunks")
    n_real = int(raster.build_bins(ps, w, H).n_real)
    full = raster.visibility(ps, w, H)
    pt, pd, aux, bins = _port_ckern(ps, w, pair_budget=n_real - 7)
    assert aux.tolist() == [7, 0]
    assert bins.banks.shape[0] == n_real - 7
    part = GBuffer(tri_id=torch.from_numpy(np.ascontiguousarray(pt)),
                   depth=torch.from_numpy(np.ascontiguousarray(pd)))
    assert _assert_degraded_cleanly(ps, full, part, 600) > 0
    # the default budget holds this scene
    assert _port_ckern(ps, w)[2].tolist() == [0, 0]


def test_triangle_id_guard_raises():
    """Bank ids ride an f32 column: 2^24 triangles or more raise before
    any work (the tensors here are zero-stride views, no memory)."""
    t = raster.CK_MAX_TRIANGLES

    def big(shape, dtype):
        return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)

    setup = TriangleSetup(edge=big((t, 3, 3), torch.float32),
                          z=big((t, 3), torch.float32),
                          w=big((t, 3), torch.float32),
                          bbox=big((t, 4), torch.int32),
                          valid=big((t,), torch.bool))
    with pytest.raises(ValueError, match="2\\^24"):
        raster.build_bins(setup, 64, 64, ck_bank=BANK)


def test_unbanked_bins_refuse_the_ck_kernel():
    (_js, ps), w = _scene("random")
    with pytest.raises(ValueError, match="compact-bank"):
        raster.visibility_ck_tiles(raster.build_bins(ps, w, H), 8, 16, BANK)


if __name__ == "__main__":
    out_npz, *jobs = sys.argv[1:]
    results = {}
    for i in range(0, len(jobs), 3):
        name, setup_npz, width = jobs[i:i + 3]
        arrays = np.load(setup_npz)
        setup = JTriangleSetup(**{f: jnp.asarray(arrays[f])
                                  for f in JTriangleSetup._fields})
        tri, depth, _aux = _jax_ckern(setup, int(width))
        results[f"{name}_tri"], results[f"{name}_depth"] = tri, depth
    np.savez(out_npz, **results)
