"""The 2× upscaler's training path on trident_tpu_torch against the JAX
package, on the CPU: ai/upscaler.py's init_upscaler, save_upscaler /
load_upscaler, the f32 history of warp_from_blocks, depth_to_space's
modes and the batched V1 forward, and scripts/train_upscaler.py (its
loss, its schedule, its random scenes, a whole run).

Tolerances: init_upscaler matches flax's distribution (variance within
15%, draws within ±2 σ), not its values; save / load round trips are bit
for bit; the f32 warp equals the port's warp_previous bit for bit and the
JAX f32 branch except where a reprojected coordinate sits within 1e-4 of
a rounding boundary (as tests/test_torch_upscaler_v1.py holds the V1
warp); one training step's loss within 1e-5 relative and its gradients
within rtol 1e-3 / atol 1e-6 of the JAX step (f32 convs in both, summed in
library orders; the bilinear resize within 2 ulps of jax.image.resize);
the cosine schedule's learning rates within 1e-9 relative of optax's,
both in float64 (optax in float32 differs from its own float64 values by
up to 1.5e-6: f32 rounding of cos near −1).
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from trident_tpu.ai import upscaler as jup

from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.scripts import train_upscaler as ptu

from test_torch_upscaler import _perturbed_params
from test_torch_upscaler_v1 import _cameras, _near_boundary_only, _scene

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
LR_RTOL = 1e-9


def _jax_script():
    """scripts/train_upscaler.py, the JAX trainer, as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_upscaler", ROOT / "scripts" / "train_upscaler.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree):
    return {f"{m}/{n}": np.asarray(a) for m, d in tree.items()
            for n, a in d.items()}


@pytest.mark.parametrize("in_channels", [3, 17])
def test_init_upscaler_draws_like_flax(in_channels):
    net = up.init_upscaler(torch.Generator().manual_seed(1), 32,
                           in_channels=in_channels, device="cpu")
    _m, variables = jup.init_upscaler(jax.random.PRNGKey(1), 32,
                                      in_channels=in_channels)
    got, want = _flat(up.params_to_flax(net)), _flat(variables["params"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.endswith("kernel") and not k.startswith("Conv_3"):
            fan_in = int(np.prod(w.shape[:-1]))
            assert abs(got[k].var() / w.var() - 1) < 0.15, k
            assert np.abs(got[k]).max() <= 2 / np.sqrt(fan_in) / 0.8796 \
                + 1e-6, k
        else:                                    # biases and the zero head
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            assert not got[k].any()
    x = torch.rand(5, 8, in_channels)
    base = up.resize_bilinear_2x(x[..., :3]).clamp(0, 1)
    assert torch.equal(net.upscale(x), base)  # the untrained net = bilinear


@pytest.mark.parametrize("in_channels", [3, 4, 16, 17])
def test_save_load_round_trip_bit_equal(tmp_path, in_channels):
    params = _perturbed_params(in_channels, 90 + in_channels)
    net = up.upscaler_from_flax(params, "cpu")
    path = up.save_upscaler(net, tmp_path / "ck")
    assert path == tmp_path / "ck" / up.UPSCALER_FILE
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    assert {k: int(arrays.pop(k)) for k in ("base_channels", "scale",
                                            "in_channels")} == {
        "base_channels": 8, "scale": 2, "in_channels": in_channels}
    want = _flat(params)
    assert arrays.keys() == want.keys()
    for k, a in want.items():
        assert arrays[k].dtype == np.float32 and \
            arrays[k].tobytes() == a.tobytes(), k
    for src in (tmp_path / "ck", path):        # the directory or the file
        back, bc = up.load_upscaler(src, "cpu")
        assert bc == 8 and up.upscaler_in_channels(back) == in_channels
        for k, v in net.state_dict().items():
            assert torch.equal(back.state_dict()[k], v), k


@pytest.mark.parametrize("orbit", [False, True], ids=["static", "orbit"])
def test_warp_from_blocks_f32_history(orbit):
    """The f32 branch (trident_tpu/ai/upscaler.py:259-264): a plain
    clipped gather, valid wherever in_bounds holds (no band window);
    given the blocks of a frame it equals warp_previous of that frame,
    bit for bit (the mirror of tests/test_upscaler.py:305)."""
    view, proj, _pos, prev_vp = _cameras(orbit)
    depth, color = _scene(orbit)
    prev = color[..., :3].astype(np.float32) * np.float32(1 / 255)
    blocks = prev.reshape(32, 2, 32, 2, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(32, 32, 12)
    inv = np.linalg.inv(proj @ view).astype(np.float32)
    t = [torch.from_numpy(a) for a in (blocks, depth, inv, prev_vp)]
    got = up.warp_from_blocks(*t, 64, 64).numpy()
    v1 = up.warp_previous(torch.from_numpy(prev), *t[1:], 64, 64).numpy()
    assert got.shape == (32, 32, 13)
    np.testing.assert_array_equal(got, v1)
    want = np.asarray(jup.warp_from_blocks(
        *(jnp.asarray(a) for a in (blocks, depth, inv, prev_vp)), 64, 64))
    _near_boundary_only(got, want, depth, inv, prev_vp)


def test_depth_to_space_modes():
    blocks = np.random.default_rng(11).random((2, 24, 40, 12), np.float32)
    ref = np.asarray(jup.depth_to_space(jnp.asarray(blocks), mode="xla"))
    for mode in (None, "convt", "pad", "xla"):
        got = up.depth_to_space(torch.from_numpy(blocks), mode=mode).numpy()
        assert got.shape == (2, 48, 80, 3)
        np.testing.assert_array_equal(got, ref, err_msg=str(mode))
    with pytest.raises(ValueError):
        up.depth_to_space(torch.from_numpy(blocks), mode="transpose")


def _jax_loss(params, x, y, ew):
    """scripts/train_upscaler.py's loss_fn (its `step`)."""
    out = jup.UpscalerNet(base_channels=8).apply({"params": params}, x)
    l1 = jnp.mean(jnp.abs(out - y))
    gx = jnp.mean(jnp.abs((out[:, :, 1:] - out[:, :, :-1])
                          - (y[:, :, 1:] - y[:, :, :-1])))
    gy = jnp.mean(jnp.abs((out[:, 1:] - out[:, :-1])
                          - (y[:, 1:] - y[:, :-1])))
    return l1 + ew * (gx + gy)


@pytest.mark.parametrize("in_channels", [3, 17])
def test_training_step_matches_jax(in_channels):
    """One step of the batched V1 forward with the edge term: loss and
    gradients of every param against the JAX script's."""
    params = _perturbed_params(in_channels, 60 + in_channels)
    rng = np.random.default_rng(in_channels)
    x = rng.random((3, 12, 16, in_channels), np.float32)
    y = rng.random((3, 24, 32, 3), np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss), static_argnums=3)(
        params, jnp.asarray(x), jnp.asarray(y), 0.25)
    net = up.upscaler_from_flax(params, "cpu").requires_grad_(True)
    out = net.upscale(torch.from_numpy(x))
    want_out = jup.UpscalerNet(base_channels=8).apply({"params": params},
                                                      jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=2e-6)
    loss = ptu.upscaler_loss(net, torch.from_numpy(x), torch.from_numpy(y),
                             0.25)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * float(jloss)
    g = up.UpscalerNet(in_channels, 8)
    g.load_state_dict({n: p.grad for n, p in net.named_parameters()})
    got, want = _flat(up.params_to_flax(g)), _flat(jgrads)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_cosine_schedule_matches_optax():
    steps, lr = 300, 2e-3
    net = up.init_upscaler(torch.Generator().manual_seed(0), 4,
                           device="cpu")
    opt, sched = ptu.make_optimizer(net, lr, steps)
    got = []
    for _ in range(steps + 3):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    with jax.enable_x64(True):
        schedule = optax.cosine_decay_schedule(lr, steps, 0.02)
        want = np.asarray([schedule(jnp.asarray(k, jnp.int64))
                           for k in range(steps + 3)])
    np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)
    assert got[0] == lr and abs(got[steps] - 0.02 * lr) < 1e-15


def test_randomize_draws_the_jax_scenes():
    """The same seed gives the same scenes: every pool's entities, sun
    and camera after two randomize calls equal the JAX script's."""
    js = _jax_script()
    from trident_tpu.ecs.components import (
        LightComponent as JLight, TextureComponent as JTex,
        TransformComponent as JTransform)
    from trident_tpu_torch.ecs.components import (
        LightComponent, TextureComponent, TransformComponent)

    for i, spec in enumerate(ptu.POOL_SPECS):
        jpool = js.build_pool(32, 5 + i, **spec)
        ppool = ptu.build_pool(32, 5 + i, device="cpu", **spec)
        assert js.POOL_SPECS[i] == spec
        for _ in range(2):
            jt = js.randomize(*jpool[:5], *jpool[5])
            pt = ptu.randomize(*ppool[:5], *ppool[5])
            np.testing.assert_array_equal(jt, pt)
        (jr, jreg, jents, jsun, _), (pr, preg, pents, psun, _) = \
            jpool[:5], ppool[:5]
        for je, pe in zip(jents, pents):
            a, b = jreg.get(je, JTransform), preg.get(pe, TransformComponent)
            for f in ("position", "rotation", "scale"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert jreg.get(je, JTex).slot == preg.get(pe, TextureComponent).slot
        a, b = jreg.get(jsun, JLight), preg.get(psun, LightComponent)
        np.testing.assert_array_equal(a.direction, b.direction)
        assert a.intensity == b.intensity
        np.testing.assert_array_equal(jr.editor_camera.view,
                                      pr.editor_camera.view)


def test_train_upscaler_runs_end_to_end(tmp_path, capsys, monkeypatch):
    """The whole script on the CPU at a tiny size: --temporal --depth (17
    input channels), two scales, a save the Renderer's loader reads. The
    pools keep their kinds (shadowed or not) but hold one or two entities:
    the CPU renders the 36- and 100-entity pools' plain visibility in
    seconds a frame, and test_randomize_draws_the_jax_scenes holds those
    pools' scenes."""
    monkeypatch.setattr(ptu, "POOL_SPECS", tuple(
        dict(spec, grid=1 + (i == 1)) for i, spec in
        enumerate(ptu.POOL_SPECS)))
    out = tmp_path / "up"
    summary = ptu.main(["--pairs", "16", "--res", "32,16", "--steps", "4",
                        "--batch", "2", "--channels", "4", "--temporal",
                        "--depth", "--out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "rendering training pairs at 32px" in text and "saved" in text
    net, bc = up.load_upscaler(out, "cpu")
    assert bc == 4 and up.upscaler_in_channels(net) == 17
    assert summary["step_ms"] is None and np.isfinite(summary["best"])
    with pytest.raises(SystemExit):
        ptu.main(["--pairs", "8", "--res", "16", "--steps", "1",
                  "--channels", "8", "--init-from", str(out),
                  "--out", str(tmp_path / "x"), "--device", "cpu"])
    json.dumps(summary)
