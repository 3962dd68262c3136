"""chip_smoke.py: its refusal off the GPU, and its phase functions at a
tiny size on the CPU (the Triton kernel through the Pallas interpreter;
the four-card phase on four virtual CPU devices)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY = cs.Size(n=2048, kernel_q=128, q_block=128, col_block=256, chunk=1024,
               exact_q=64, recall_q=32, prefix=1024, budget=200, best=20,
               parity_budget=100, four_n=2048, four_build_n=1024)


@pytest.mark.parametrize("alone", [False, True])
def test_fails_without_gpu(tmp_path, alone):
    """Non-zero exit and no result line on the CPU, and in a directory
    holding the script and nothing else of the repo."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def lib():
    return cs.make_library(TINY.n, TINY.recall_q, seed=0)


@pytest.fixture(scope="module")
def built(lib):
    return cs.phase_build(lib, TINY, interpret=True)


def test_phase_kernels(lib):
    res = cs.phase_kernels(lib, TINY, interpret=True)
    assert res["ok"], res
    assert res["inter_diff"] == res["dist_diff"] == 0
    assert res["exact_key_diff"] == res["xla_key_diff"] == 0


def test_phase_build(built):
    idx, res = built
    assert res["ok"], res
    assert res["rows_differing_per_layer"] == [0] * (idx.graph.max_level + 1)


def test_phase_traverse(built, lib):
    res = cs.phase_traverse(built[0], lib, TINY)
    assert res["ok"], res
    assert res["parity_common"] >= TINY.parity_budget


def test_phase_device_scored(built, lib):
    res = cs.phase_device_scored(built[0], lib, TINY)
    assert res["ok"], res


def test_phase_knn_server(built, lib):
    res = cs.phase_knn_server(built[0], lib, TINY)
    assert res["ok"], res


def test_phase_four_on_virtual_devices():
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    res = cs.phase_four(TINY, 0, devices, interpret=True)
    assert res["ok"], res


@pytest.mark.gpu
def test_phases_on_gpu(gpu):
    """The one-card phases at an eighth of the full library."""
    size = dataclasses.replace(cs.FULL, n=1 << 17, prefix=20_000,
                               budget=1311, best=100, parity_budget=500)
    lib = cs.make_library(size.n, size.recall_q, seed=0)
    assert cs.phase_kernels(lib, size)["ok"]
    idx, res = cs.phase_build(lib, size)
    assert res["ok"], res
    for phase in (cs.phase_traverse, cs.phase_device_scored,
                  cs.phase_knn_server):
        assert phase(idx, lib, size)["ok"]
