"""The port's split-select probe (trident_tpu_torch/tools_dev/
diag_split_kernel.py) against the JAX script tools_dev/diag_split_kernel.py.

The planes: the port splits with torch.bfloat16, the JAX script with
ml_dtypes; both round f32 → bf16 to nearest even, so the planes are bit-
equal (the script's make_inputs is copied below: the script runs its
probes when imported). The select is exact (a one-hot product only
selects), so the port's plain select equals host_parts with error 0, and
the JAX script, run in a child process under JAX_PLATFORMS=cpu
(interpret mode), prints the same report lines as the port's tool with
--device cpu.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from trident_tpu_torch.tools_dev import diag_split_kernel as dsk

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_make_inputs(rw, seed=0):
    """tools_dev/diag_split_kernel.py:42-55, as the script has it."""
    C, NC = dsk.C, dsk.NC
    rng = np.random.default_rng(seed)
    rec = rng.standard_normal((rw, NC * C)).astype(np.float32)
    import ml_dtypes
    bf = ml_dtypes.bfloat16
    hi = rec.astype(bf).astype(np.float32)
    r1 = rec - hi
    mid = r1.astype(bf).astype(np.float32)
    lo = (r1 - mid).astype(bf)
    planes = np.stack([hi.astype(bf), mid.astype(bf), lo], axis=0)
    win = rng.integers(0, C, (C,))
    oh = np.zeros((C, C), np.float32)
    oh[win, np.arange(C)] = 1.0
    return planes, oh


@pytest.mark.parametrize("rw", dsk.RWS)
def test_planes_bit_equal_to_ml_dtypes_split(rw):
    planes, oh = dsk.make_inputs(rw)
    j_planes, j_oh = _jax_make_inputs(rw)
    assert planes.dtype == torch.bfloat16 and planes.shape == j_planes.shape
    assert np.array_equal(planes.view(torch.int16).numpy(),
                          j_planes.view(np.int16))
    assert np.array_equal(oh, j_oh)


@pytest.mark.parametrize("form", sorted(dsk.FORMS))
@pytest.mark.parametrize("rw", dsk.RWS)
def test_plain_select_equals_host_parts(form, rw):
    planes, oh = dsk.make_inputs(rw)
    want = dsk.host_parts(planes, oh)
    before = dsk.split_select.launches
    parts, total = dsk.split_select(**dsk.form_inputs(form, planes, oh,
                                                      "cpu"))
    assert dsk.split_select.launches == before       # CPU: the plain version
    assert (parts is None) == (form == "K3")
    if parts is not None:
        for k in range(3):
            assert np.array_equal(parts[k].numpy(), want[k])
    assert np.array_equal(total.numpy(), want[0] + want[1] + want[2])
    # the reassembled sum is the f32 record to within bf16's split
    assert np.abs(total.numpy()).max() > 0.5


def test_column_outside_the_row_reads_nan():
    planes, oh = dsk.make_inputs(27)
    win = torch.tensor([0, 255, 3], dtype=torch.int32)
    parts, total = dsk.split_select(planes, win, off=3 * dsk.C + 1)
    assert not torch.isnan(total[:, 0]).any()
    assert torch.isnan(total[:, 1]).all() and torch.isnan(parts[:, :, 1]).all()
    assert (total[:, 2] == (planes[0, :, 3 * dsk.C + 4].float()
                            + planes[1, :, 3 * dsk.C + 4].float())
            + planes[2, :, 3 * dsk.C + 4].float()).all()


def _report_lines(text: str):
    """Each probe's `Kn rw=N` header and its indented report lines."""
    out = []
    for line in text.splitlines():
        m = re.match(r"(K\d rw=\d+) \(", line)
        if m:
            out.append(m.group(1))
        elif line.startswith("  ") or line == "DONE":
            out.append(line)
    return out


def test_report_lines_match_the_jax_script(capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools_dev" / "diag_split_kernel.py")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    dsk.main(["--device", "cpu"])
    port = _report_lines(capsys.readouterr().out)
    assert len(port) == 2 * (5 + 5 + 2) + 1
    assert port == _report_lines(proc.stdout)
    assert all("maxerr=0.000e+00 neq=0.0000" in line
               for line in port if line.startswith("  "))
