"""The port's gather probe (trident_tpu_torch/tools_dev/gather_probe.py)
against the JAX script's own Pallas kernels, run in interpret mode on the
JAX script's seeded inputs.

tools_dev/ has no __init__.py, so the JAX script is loaded by path; loading
it runs nothing but `import trident_tpu`. Its lut_gather is jitted for the
TPU, so the tests call `pallas_call` on its kernel body (gather_probe.py:19)
with interpret=True, and on copies of its quad and frame kernels
(gather_probe.py:79-84, 108-109). Every comparison is exact: a gather
moves i32 words.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas

from trident_tpu_torch.tools_dev import gather_probe as gp

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_gather_probe", ROOT / "tools_dev" / "gather_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return gp.make_inputs()


def _port(tab: np.ndarray, idx: np.ndarray):
    """(the port's gather, torch.gather in its layout) for (K, rows, L)
    tables and (G, n, L) idx, on the CPU."""
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    before = gp.lut_gather.launches
    got = gp.lut_gather(t, i).numpy()
    assert gp.lut_gather.launches == before          # CPU: the plain version
    lib = gp.library_gather(t, i.long()).view(t.shape[0], *i.shape)
    return got, lib.transpose(0, 1).numpy()


def test_inputs_are_the_jax_scripts_draws(inputs):
    """make_inputs draws as gather_probe.py:52-53, 74-75, 103-104 do."""
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 1 << 30, (gp.R, gp.L), dtype=np.int32)
    idx = rng.integers(0, gp.R, (gp.R, gp.L), dtype=np.int32)
    tabs = [rng.integers(0, 1 << 30, (gp.R, gp.L), dtype=np.int32)
            for _ in range(4)]
    tab2 = rng.integers(0, 1 << 30, (gp.R2, gp.L), dtype=np.int32)
    idx8 = rng.integers(0, gp.R2, (gp.G, gp.R2, gp.L), dtype=np.int32)
    for name, want in (("tab", tab), ("idx", idx), ("tabs", np.stack(tabs)),
                       ("tab2", tab2), ("idx8", idx8)):
        assert np.array_equal(inputs[name], want), name


def test_lut_gather_matches_the_pallas_kernel(jax_probe, inputs):
    tab, idx = inputs["tab"], inputs["idx"]
    want = np.asarray(pallas.pallas_call(
        jax_probe.kernel,
        out_shape=jax.ShapeDtypeStruct((gp.R, gp.L), jnp.int32),
        interpret=True)(jnp.asarray(tab), jnp.asarray(idx)))
    got, lib = _port(tab[None], idx[None])
    assert np.array_equal(got[0, 0], want)
    assert np.array_equal(lib[0, 0], want)


def test_quad_gather_matches_the_pallas_kernel(inputs):
    def k(i_ref, a_ref, b_ref, c_ref, d_ref, o_ref):       # :79-84
        i = i_ref[...]
        o_ref[0] = jnp.take_along_axis(a_ref[...], i, axis=0)
        o_ref[1] = jnp.take_along_axis(b_ref[...], i, axis=0)
        o_ref[2] = jnp.take_along_axis(c_ref[...], i, axis=0)
        o_ref[3] = jnp.take_along_axis(d_ref[...], i, axis=0)

    tabs, idx = inputs["tabs"], inputs["idx"]
    want = np.asarray(pallas.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((4, gp.R, gp.L), jnp.int32),
        interpret=True)(jnp.asarray(idx), *map(jnp.asarray, tabs)))
    got, lib = _port(tabs, idx[None])
    assert got.shape == (1, 4, gp.R, gp.L)
    assert np.array_equal(got[0], want)
    assert np.array_equal(lib[0], want)


def test_chunked_gather_matches_the_pallas_kernel(inputs):
    """lut_frame's grid over idx chunks (gather_probe.py:106-122), on the
    first two of its eight chunks."""
    g = 2
    tab2, idx = inputs["tab2"], inputs["idx8"][:g]

    def k(i_ref, t_ref, o_ref):                             # :108-109
        o_ref[0] = jnp.take_along_axis(t_ref[...], i_ref[0], axis=0)

    want = np.asarray(pallas.pallas_call(
        k, grid=(g,),
        in_specs=[pallas.BlockSpec((1, gp.R2, gp.L), lambda c: (c, 0, 0)),
                  pallas.BlockSpec((gp.R2, gp.L), lambda c: (0, 0))],
        out_specs=pallas.BlockSpec((1, gp.R2, gp.L), lambda c: (c, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((g, gp.R2, gp.L), jnp.int32),
        interpret=True)(jnp.asarray(idx), jnp.asarray(tab2)))
    got, lib = _port(tab2[None], idx)
    assert got.shape == (g, 1, gp.R2, gp.L)
    assert np.array_equal(got[:, 0], want)
    assert np.array_equal(lib[:, 0], want)


def test_index_out_of_range_reads_minus_one():
    tab = torch.arange(2 * 4 * 8, dtype=torch.int32).view(2, 4, 8)
    idx = torch.tensor([[[0, 3, -1, 4, 2, 1, 7, 3]]], dtype=torch.int32)
    out = gp.lut_gather(tab, idx)
    lanes = torch.arange(8)
    for k in range(2):
        want = torch.where((idx[0, 0] >= 0) & (idx[0, 0] < 4),
                           tab[k, idx[0, 0].clamp(0, 3).long(), lanes], -1)
        assert (out[0, k, 0] == want).all()


def test_gather_probe_cli_on_cpu(capsys):
    gp.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    checks = [line for line in out if "take_along_axis" in line]
    assert len(checks) == 3 and all(c.endswith(": True") for c in checks)
    assert out[-1] == "cpu"
