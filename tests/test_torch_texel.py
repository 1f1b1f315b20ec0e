"""Port texel fetch vs the JAX package's sampler and texel kernel.

Index math (idx, fx, fy) and the plain fetch must be bitwise equal to the
JAX functions evaluated op by op, uncovered pixels (idx = −1) included.
The windowed one-hot kernel (sample_bilinear_mxu, interpret mode, jitted)
is held two ways:
  * bitwise, in a child process whose XLA:CPU may not emit FMAs
    (--xla_cpu_max_isa=AVX): there every product and sum rounds once, as
    in PyTorch's eager ops and in the CUDA kernel built with -fmad=false;
  * within 4 float32 ulps (3 measured) in this process, where XLA:CPU
    contracts the lerps a·(1−f) + b·f into FMAs. The JAX package holds
    the same pair to 2e-6 absolute.
Run as a script, this file is that child: `python test_torch_texel.py
IN.npz OUT.npy` samples IN's table with the kernel into OUT.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ops import shading as jshading
from trident_tpu.ops import texel_pallas as jtp
from trident_tpu.render.textures import TextureSlots as JTextureSlots

from trident_tpu_torch.ops import resolve, shading, texel
from trident_tpu_torch.ops.deferred import texel_lookup
from trident_tpu_torch.render.textures import TextureSlots
from trident_tpu_torch.render.types import from_numpy

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZES = ((64, 64), (16, 16), (40, 24))


def _textures():
    rng = np.random.default_rng(5)
    js, ps = JTextureSlots(), TextureSlots()
    for k, (w, h) in enumerate(SIZES):
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        js.acquire(f"t{k}", img)
        ps.acquire(f"t{k}", img)
    return js.device_arrays(), ps.device_arrays("cpu")


def _lookup_inputs(jt, h=48, w=200, seed=11):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.2, 2.4, (h, w, 2)).astype(np.float32)
    mip = rng.uniform(0.0, 7.0, (h, w)).astype(np.float32)
    level = np.round(np.clip(mip, 0, int(jt.max_level))).astype(np.int32)
    rows = np.asarray(jt.sizes)[rng.integers(1, len(SIZES) + 1, (h, w))]
    return uv, level, rows


def test_tables_match():
    jt, pt = _textures()
    conv = from_numpy(jt, "cpu")
    for f in jt._fields:
        assert (getattr(conv, f) == getattr(pt, f)).all()


def test_index_math_bitwise():
    jt, _pt = _textures()
    uv, level, rows = _lookup_inputs(jt)
    with jax.disable_jit():
        ji, jfx, jfy = jshading.bilinear_index(
            jt, None, jnp.asarray(uv), jnp.asarray(level),
            tuple(jnp.asarray(rows[..., k]) for k in range(4)))
    pi, pfx, pfy = shading.bilinear_index(
        torch.from_numpy(uv), torch.from_numpy(level),
        tuple(torch.from_numpy(rows[..., k]) for k in range(4)))
    assert (pi.numpy() == np.asarray(ji)).all()
    assert (pfx.numpy() == np.asarray(jfx)).all()
    assert (pfy.numpy() == np.asarray(jfy)).all()
    assert (uv < 0).any()               # the floor-modulo wrap is exercised


def _fetch_inputs():
    """Textures, per-pixel (idx, fx, fy) with 10% uncovered (idx = −1),
    and the JAX sampler's _bilinear_flat at the covered pixels."""
    jt, pt = _textures()
    uv, level, rows = _lookup_inputs(jt)
    size_hint = tuple(jnp.asarray(rows[..., k]) for k in range(4))
    with jax.disable_jit():
        ji, jfx, jfy = jshading.bilinear_index(
            jt, None, jnp.asarray(uv), jnp.asarray(level), size_hint)
        flat = np.asarray(jshading._bilinear_flat(
            jt, None, jnp.asarray(uv), jnp.asarray(level), size_hint))
    idx = np.array(ji)
    idx[np.random.default_rng(1).uniform(size=idx.shape) < 0.1] = -1
    return jt, pt, idx, np.array(jfx), np.array(jfy), flat


def _mxu_fetch(quads, idx, fx, fy) -> np.ndarray:
    table = jtp.build_texel_table(jnp.asarray(quads))
    return np.asarray(jax.jit(lambda i, a, b: jtp.sample_bilinear_mxu(
        table, i, a, b, interpret=True))(idx, fx, fy))


def _port_fetch(pt, idx, fx, fy) -> np.ndarray:
    return texel.sample_bilinear(pt.quads, torch.from_numpy(idx),
                                 torch.from_numpy(fx),
                                 torch.from_numpy(fy)).numpy()


def test_fetch_bitwise_vs_bilinear_flat_and_ulp_vs_kernel():
    jt, pt, idx, fx, fy, flat = _fetch_inputs()
    out = _port_fetch(pt, idx, fx, fy)
    covered = idx >= 0
    assert (out[covered].view(np.int32) == flat[covered].view(np.int32)).all()
    assert (out[~covered] == 0).all()

    mxu = _mxu_fetch(jt.quads, idx, fx, fy)
    assert (mxu[~covered] == 0).all()
    ulp = np.spacing(np.maximum(np.abs(mxu), np.abs(out)).astype(np.float32))
    assert (np.abs(mxu - out) <= 4 * ulp).all()


def test_fetch_bitwise_vs_kernel_without_fma(tmp_path):
    jt, pt, idx, fx, fy, _flat = _fetch_inputs()
    src, dst = tmp_path / "in.npz", tmp_path / "out.npy"
    np.savez(src, quads=np.asarray(jt.quads), idx=idx, fx=fx, fy=fy)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, str(src), str(dst)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    mxu = np.load(dst)
    out = _port_fetch(pt, idx, fx, fy)
    assert (idx < 0).any() and (mxu[idx < 0] == 0).all()
    assert (out.view(np.int32) == mxu.view(np.int32)).all()


def test_sample_texture_bitwise():
    """sample_texture (bilinear at the clamped, half-to-even rounded mip
    level) against the JAX sampler evaluated op by op."""
    jt, pt = _textures()
    uv, _level, rows = _lookup_inputs(jt)
    mip = np.random.default_rng(8).uniform(-1.0, 9.0, uv.shape[:2])
    mip = mip.astype(np.float32)
    mip[:4, :4] = 2.5                       # ties round to even
    with jax.disable_jit():
        ref = np.asarray(jshading.sample_texture(
            jt, None, jnp.asarray(uv), jnp.asarray(mip), mode="bilinear",
            size_hint=tuple(jnp.asarray(rows[..., k]) for k in range(4))))
    out = shading.sample_texture(
        pt, torch.from_numpy(uv), torch.from_numpy(mip),
        size_hint=tuple(torch.from_numpy(rows[..., k]) for k in range(4)))
    assert (out.numpy().view(np.int32) == ref.view(np.int32)).all()


def test_texel_lookup_matches_jax_derivation():
    """The port's texel inputs from a resolved attribute image equal the
    JAX forward path's (deferred_shade_attrs → _shade_common) derivation."""
    jt, pt = _textures()
    rng = np.random.default_rng(4)
    h, w = 32, 64
    attrs = np.zeros((h, w, resolve.CHANNELS), np.float32)
    sizes = np.asarray(jt.sizes)
    slot = rng.integers(1, len(SIZES) + 1, (h, w))
    attrs[..., resolve.CH_U:resolve.CH_V + 1] = rng.uniform(-1, 2, (h, w, 2))
    attrs[..., resolve.CH_MIP] = rng.uniform(-2, 9, (h, w))
    attrs[..., resolve.CH_TSX] = sizes[slot, 0]
    attrs[..., resolve.CH_TSY] = sizes[slot, 1]
    attrs[..., resolve.CH_BASE8] = sizes[slot, 2]
    covered = rng.uniform(size=(h, w)) < 0.8

    with jax.disable_jit():
        a = jnp.asarray(attrs)
        w0 = a[..., resolve.CH_TSX].astype(jnp.int32)
        h0 = a[..., resolve.CH_TSY].astype(jnp.int32)
        base8 = a[..., resolve.CH_BASE8].astype(jnp.int32)
        m = jnp.maximum(jnp.maximum(w0, h0), 1) - 1
        for k in (1, 2, 4, 8, 16):
            m = m | (m >> k)
        mip_i = jnp.round(jnp.clip(a[..., resolve.CH_MIP], 0.0, jt.max_level
                                   .astype(jnp.float32))).astype(jnp.int32)
        ji, jfx, jfy = jshading.bilinear_index(
            jt, None, a[..., resolve.CH_U:resolve.CH_V + 1], mip_i,
            (w0, h0, base8, m + 1))
        ji = jnp.where(jnp.asarray(covered), ji, -1)
    pi, pfx, pfy = texel_lookup(torch.from_numpy(attrs),
                                torch.from_numpy(covered), pt.max_level)
    assert (pi.numpy() == np.asarray(ji)).all()
    assert (pfx.numpy() == np.asarray(jfx)).all()
    assert (pfy.numpy() == np.asarray(jfy)).all()


if __name__ == "__main__":
    arrays = np.load(sys.argv[1])
    np.save(sys.argv[2], _mxu_fetch(arrays["quads"], arrays["idx"],
                                    arrays["fx"], arrays["fy"]))
