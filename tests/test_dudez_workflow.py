"""The DUDE-Z workflow example reproduces the reference's headline claim
(>50% of top scorers found at ≤10% scored, reference index.html:628) on the
faithful-proxy library, and emits a sane enrichment curve."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "dudez_workflow.py")


@pytest.mark.slow
@pytest.mark.slow
def test_dudez_workflow_headline(tmp_path):
    out = tmp_path / "dudez.json"
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS="")
    r = subprocess.run(
        [sys.executable, SCRIPT, "--n", "12000", "--expansion-add", "48",
         "--json-out", str(out)],
        capture_output=True, text=True, env=env, timeout=560)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(out.read_text())
    curve = {float(k): v for k, v in rec["curve"].items()}
    # headline: >50% of the true top-100 at <=10% scored
    assert rec["at_10pct"] > 0.5, rec
    # the curve is a cumulative prefix statistic: monotone non-decreasing
    xs = sorted(curve)
    ys = [curve[x] for x in xs]
    assert all(b >= a for a, b in zip(ys, ys[1:]))
    # and meaningfully better than random at 5%
    assert curve[0.05] > 3 * 0.05, curve


@pytest.mark.slow
@pytest.mark.slow
def test_dudez_workflow_morgan_chemistry(tmp_path):
    """Real-chemistry mode: combinatorial drug-like SMILES + in-tree
    Morgan/ECFP fingerprints reproduce the enrichment behavior (the
    non-proxy validation path)."""
    out = tmp_path / "dudez_morgan.json"
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS="")
    r = subprocess.run(
        [sys.executable, SCRIPT, "--chemistry", "morgan", "--n", "12000",
         "--expansion-add", "48", "--json-out", str(out)],
        capture_output=True, text=True, env=env, timeout=560)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(out.read_text())
    assert rec["at_10pct"] > 0.5, rec
    curve = {float(k): v for k, v in rec["curve"].items()}
    # small-scale libraries reach the active scaffold later than the 40k
    # flagship run (64% at 1% there); gate on clearly-better-than-random
    # at the 10% budget
    assert curve[0.10] > 3 * 0.10, curve


@pytest.mark.slow
def test_dudez_workflow_real_data_files(tmp_path):
    """The --smiles-file/--scores-file real-data path runs end-to-end
    without RDKit (falls back to the in-tree Morgan/ECFP) — README's
    'wired but unexercised' gap, closed. Mechanics only at this scale;
    the enrichment thresholds are pinned by the morgan-chemistry test
    (measured: 73% of top-100 at 10% scored at n=12000 via these same
    files)."""
    from rad_tpu.chem.library import make_smiles_library

    smiles, scores = make_smiles_library(1500, seed=3)
    smi = tmp_path / "lib.smi"
    csv = tmp_path / "scores.csv"
    smi.write_text("".join(s + "\n" for s in smiles))
    csv.write_text("".join(f"{s},{sc}\n" for s, sc in zip(smiles, scores)))
    out = tmp_path / "real.json"
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS="")
    r = subprocess.run(
        [sys.executable, SCRIPT, "--smiles-file", str(smi),
         "--scores-file", str(csv), "--n-bits", "256",
         "--expansion-add", "32", "--max-frac", "0.2",
         "--json-out", str(out)],
        capture_output=True, text=True, env=env, timeout=560)
    # rc reflects headline reproduction, which needs >=~10k molecules
    # (measured: 24% at 10% at n=1500, 73% at n=12000) — this test pins
    # the file-path mechanics, so only a crash fails it
    assert "Traceback" not in r.stderr, r.stdout + r.stderr
    assert out.exists(), r.stdout + r.stderr
    assert "in-tree Morgan/ECFP" in r.stderr          # RDKit-free fallback
    assert f"real data: {len(smiles)} molecules" in r.stdout
    rec = json.loads(out.read_text())
    curve = {float(k): v for k, v in rec["curve"].items()}
    xs = sorted(curve)
    ys = [curve[x] for x in xs]
    assert all(b >= a for a, b in zip(ys, ys[1:]))    # cumulative prefix
    assert ys[-1] > 0                                 # finds actives
