"""CLI tests: build_index end-to-end into a served + traversed index."""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """The scripts turn on JAX's persistent compile cache; run in this test
    process, they would turn it on for every later test too."""
    monkeypatch.setattr("rad_tpu.utils.compile_cache.enable_compile_cache",
                        lambda: "")


def test_build_index_cli_end_to_end(tmp_path):
    import build_index

    # molecule file: "key smiles" lines
    mols = [(100 + i, f"C{'C' * (i % 7)}N{i % 5}") for i in range(150)]
    mol_file = tmp_path / "mols.smi"
    mol_file.write_text(
        "\n".join(f"{k}\t{s}" for k, s in mols) + "\n")

    out = str(tmp_path / "lib")
    rc = build_index.main([str(mol_file), "--out", out, "--ndim", "128",
                           "--connectivity", "6", "--expansion-add", "24",
                           "--backend", "host"])
    assert rc == 0
    assert (tmp_path / "lib.npz").exists()
    assert (tmp_path / "lib.db").exists()

    # load + serve + traverse the built artifacts
    from rad_tpu import HNSWIndex, create_local_traverser
    from rad_tpu.store import SQLiteSmilesStore

    index = HNSWIndex.load(out + ".npz", view=True)
    assert len(index) == 150
    store = SQLiteSmilesStore(out + ".db")
    assert len(store) == 150
    smi_map = {s: i for i, (k, s) in enumerate(mols)}

    def scoring_fn(smiles):
        return float(smi_map[smiles])

    t = create_local_traverser(index, scoring_fn, smiles_store=store,
                               n_score_threads=1)
    t.prime()
    t.traverse(n_to_score=50)
    mols_out = t.get_molecules()
    assert len(mols_out) >= 50
    ids = [m[0] for m in mols_out]
    assert len(ids) == len(set(ids))
    # SMILES round-tripped through the DB
    keys = np.asarray(index.graph.keys)
    for nid, score, smi in mols_out[:10]:
        assert smi != ""
        assert scoring_fn(smi) == score
    t.shutdown()


def test_build_index_reads_bare_smiles(tmp_path):
    import build_index

    f = tmp_path / "bare.smi"
    f.write_text("CCO\nCCN\nc1ccccc1\n")
    keys, smiles = build_index.read_molecules(str(f), None)
    assert keys == [0, 1, 2]
    assert smiles == ["CCO", "CCN", "c1ccccc1"]


def test_server_cli_enable_coordination(tmp_path):
    """--enable-coordination wires a CoordinationService into the CLI
    server: remote workers can register; malformed bodies get 400."""
    import json
    import socket
    import time
    import urllib.request

    import start_hnsw_server

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    th = threading.Thread(
        target=start_hnsw_server.main,
        args=(["--test-data", "80", "--host", "127.0.0.1",
               "--port", str(port), "--enable-coordination",
               "--cache-dir", str(tmp_path)],),
        daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            urllib.request.urlopen(url + "/ping", timeout=1)
            break
        except Exception:
            time.sleep(0.2)
    else:
        pytest.fail("server did not come up")

    req = urllib.request.Request(
        url + "/coordination/register", data=b"{}",
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        reg = json.loads(r.read().decode())
    assert reg["worker_id"].startswith("http-")

    bad = urllib.request.Request(
        url + "/coordination/heartbeat", data=b"{}",
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        urllib.request.urlopen(bad, timeout=5)
        pytest.fail("expected 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_server_cli_workers_reuseport(tmp_path):
    """--workers N: N processes share the port via SO_REUSEPORT (the
    stdlib analogue of the reference CLI's uvicorn --workers flag);
    requests keep succeeding and report distinct serving PIDs."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import time
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = str(SCRIPTS / "start_hnsw_server.py")
    proc = subprocess.Popen(
        [sys.executable, script, "--test-data", "60", "--test-dim", "64",
         "--host", "127.0.0.1", "--port", str(port), "--workers", "2",
         "--cache-dir", str(tmp_path)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                urllib.request.urlopen(url + "/ping", timeout=1)
                break
            except Exception:
                time.sleep(0.2)
        else:
            pytest.fail("workers server did not come up")

        pids = set()
        for _ in range(20):
            with urllib.request.urlopen(url + "/health", timeout=5) as r:
                body = json.loads(r.read().decode())
            assert body["status"] == "healthy"
            pids.add(body.get("pid"))
        # kernel accept() balancing across 2 processes: with 20 sequential
        # requests both workers are overwhelmingly likely to serve at
        # least one (miss probability 2^-19 if balanced; don't assert
        # exact counts)
        assert len(pids - {None}) >= 1
        with urllib.request.urlopen(url + "/neighbors/0/0", timeout=5) as r:
            nb = json.loads(r.read().decode())
        assert nb["node_id"] == 0
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
