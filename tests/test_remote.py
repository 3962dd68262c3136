"""HTTP server + remote client tests.

Mirrors the reference's network-integration strategy
(tests/test_remote_hnsw.py: real server on loopback, client health/top/
neighbors/info, connect-failure handling, end-to-end traversal over HTTP;
tests/test_smiles_integration.py: SMILES format checks, auth)."""

import threading

import numpy as np
import pytest

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.server.http_server import create_hnsw_server
from rad_tpu.service.remote import (
    RemoteCoordinationClient,
    RemoteHNSWService,
)
from rad_tpu.store.smiles_store import InMemorySmilesStore
from rad_tpu.traverse.coordinator import CoordinationService
from rad_tpu.traverse.workers import ScoringWorker
from rad_tpu.api.traverser import RADTraverser


@pytest.fixture(scope="module")
def graph():
    fps = random_fingerprints(100, n_bits=64, density=0.3, seed=13)
    return build_hnsw(fps, connectivity=4, expansion_add=16, seed=1)


@pytest.fixture(scope="module")
def store(graph):
    keys = np.asarray(graph.keys)
    return InMemorySmilesStore({int(k): f"SM_{int(k)}" for k in keys})


@pytest.fixture(scope="module")
def server(graph, store, tmp_path_factory):
    cache_dir = str(tmp_path_factory.mktemp("top_cache"))
    srv, app = create_hnsw_server(graph, host="127.0.0.1", port=0,
                                  smiles_store=store, cache_dir=cache_dir)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    yield f"http://127.0.0.1:{port}", app
    srv.shutdown()


def test_ping_health_info(server, graph):
    url, _ = server
    svc = RemoteHNSWService(url, max_retries=1)
    assert svc.is_healthy()
    info = svc.get_hnsw_info()
    assert info["size"] == len(graph)
    assert info["max_level"] == graph.max_level
    sinfo = svc.get_service_info()
    assert sinfo["service_type"] == "remote"
    svc.shutdown()


def test_neighbors_and_top_nodes_format(server, graph, store):
    url, _ = server
    svc = RemoteHNSWService(url, max_retries=1)
    top = svc.get_top_level_nodes()
    assert len(top) == 2 * graph.layer_sizes[graph.max_level]
    nbrs = svc.get_neighbors(0, 0)
    assert len(nbrs) % 2 == 0 and len(nbrs) > 0
    # [id, smiles, ...] with real SMILES from the store
    keys = np.asarray(graph.keys)
    for nid, smi in zip(nbrs[0::2], nbrs[1::2]):
        assert smi == f"SM_{int(keys[nid])}"
    svc.shutdown()


def test_invalid_requests_400(server, graph):
    url, _ = server
    svc = RemoteHNSWService(url, max_retries=1)
    with pytest.raises(ValueError):
        svc.get_neighbors(len(graph) + 50, 0)
    with pytest.raises(ValueError):
        svc.get_neighbors(0, graph.max_level + 5)
    svc.shutdown()


def test_top_level_cache_persisted(server):
    url, app = server
    svc = RemoteHNSWService(url, max_retries=1)
    svc.get_top_level_nodes()
    svc.get_top_level_nodes()
    import glob, os
    files = glob.glob(os.path.join(app.cache_dir, "top_nodes_*.json"))
    assert len(files) == 1
    svc.shutdown()


def test_metrics_counters(server):
    url, app = server
    stats = app.metrics.get_stats()
    assert stats["total_requests"] > 0
    assert any(k.startswith("/neighbors") for k in
               stats["requests_by_endpoint"])


def test_connect_failure_raises():
    svc = RemoteHNSWService("http://127.0.0.1:1", max_retries=1,
                            backoff_factor=0.01, timeout=0.5)
    assert svc.is_healthy() is False
    with pytest.raises(ConnectionError):
        svc.get_top_level_nodes()
    svc.shutdown()


def test_auth_required(graph, store):
    srv, app = create_hnsw_server(graph, host="127.0.0.1", port=0,
                                  smiles_store=store, api_key="sekrit")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        bad = RemoteHNSWService(url, max_retries=0)
        with pytest.raises(ValueError):
            bad.get_top_level_nodes()
        bad.shutdown()
        good = RemoteHNSWService(url, api_key="sekrit", max_retries=0)
        assert len(good.get_top_level_nodes()) > 0
        good.shutdown()
    finally:
        srv.shutdown()


def test_static_file_serving(graph, store, tmp_path):
    import requests as rq

    static = tmp_path / "static"
    static.mkdir()
    (static / "index.html").write_text("<h1>rad-tpu</h1>")
    srv, _ = create_hnsw_server(graph, host="127.0.0.1", port=0,
                                smiles_store=store, static_dir=str(static))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        r = rq.get(f"{url}/static/index.html", timeout=5)
        assert r.status_code == 200
        assert "rad-tpu" in r.text
        assert "text/html" in r.headers["Content-Type"]
        assert rq.get(f"{url}/static/../secret", timeout=5).status_code \
            in (403, 404)
        assert rq.get(f"{url}/static/nope.js", timeout=5).status_code == 404
    finally:
        srv.shutdown()


def test_remote_traversal_end_to_end(server, graph):
    """Full prime+traverse through the HTTP service (remote deployment)."""
    url, _ = server
    keys = np.asarray(graph.keys)
    rng = np.random.default_rng(8)
    table = {int(k): float(s)
             for k, s in zip(keys, rng.permutation(len(keys)).astype(float))}

    def scoring_fn(smiles):
        return table[int(smiles.split("_")[1])]

    svc = RemoteHNSWService(url, max_retries=1)
    t = RADTraverser(hnsw_service=svc, scoring_fn=scoring_fn,
                     deployment_mode="remote")
    assert t.engine == "host"
    t.prime()
    stats = t.traverse(n_workers=2, n_to_score=40, poll_interval=0.02)
    assert stats["n_scored"] >= 40 or stats["termination_reason"] == "queue_empty"
    ids = [m[0] for m in t.get_molecules()]
    assert len(ids) == len(set(ids))
    t.shutdown()


def test_remote_worker_joins_over_http(graph, store):
    """A ScoringWorker on 'another machine' attaches via the coordination
    endpoints — HTTP replacement for the shared-Redis fan-out."""
    from rad_tpu.service.local import LocalHNSWService

    service = LocalHNSWService(graph, store)
    coord = CoordinationService(service, heartbeat_interval=0.5)
    srv, app = create_hnsw_server(graph, host="127.0.0.1", port=0,
                                  smiles_store=store, coordination=coord)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    keys = np.asarray(graph.keys)
    rng = np.random.default_rng(8)
    table = {int(k): float(s)
             for k, s in zip(keys, rng.permutation(len(keys)).astype(float))}

    def scoring_fn(smiles):
        return table[int(smiles.split("_")[1])]

    try:
        # prime directly on the head-node coordination state
        top = service.get_top_level_nodes()
        start_level = max(0, graph.max_level - 1)
        for nid, smi in zip(top[0::2], top[1::2]):
            s = scoring_fn(smi)
            coord.scored_set.insert(nid, s, smi)
            if not coord.visited_set.checkAndInsert(nid, start_level):
                coord.priority_queue.insert(nid, start_level, s)
        coord.start()

        client = RemoteCoordinationClient(url, max_retries=1)
        w = ScoringWorker(client, scoring_fn, poll_interval=0.01)
        w.start()
        import time
        deadline = time.time() + 30
        while time.time() < deadline:
            done, _ = coord.check_termination(n_to_score=50)
            if done:
                break
            time.sleep(0.05)
        w.stop()
        client.shutdown()
        mols = coord.scored_set.get_molecules()
        assert len(mols) >= 50
        ids = [m[0] for m in mols]
        assert len(ids) == len(set(ids))
        remote_stats = RemoteHNSWService(url, max_retries=1)._request(
            "GET", "/coordination/stats")
        assert remote_stats["total_scored"] >= 50
    finally:
        coord.shutdown()
        srv.shutdown()


def test_remote_fail_work_requeues(graph, store):
    """RemoteCoordinationClient.fail_work releases a failed item over
    /coordination/fail for immediate requeue."""
    from rad_tpu.service.local import LocalHNSWService

    service = LocalHNSWService(graph, store)
    coord = CoordinationService(service, heartbeat_interval=0.5)
    srv, app = create_hnsw_server(graph, host="127.0.0.1", port=0,
                                  smiles_store=store, coordination=coord)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        top = service.get_top_level_nodes()
        start_level = max(0, graph.max_level - 1)
        for nid, smi in zip(top[0::2], top[1::2]):
            coord.scored_set.insert(nid, 1.0, smi)
            if not coord.visited_set.checkAndInsert(nid, start_level):
                coord.priority_queue.insert(nid, start_level, 1.0)
        client = RemoteCoordinationClient(url, max_retries=1)
        client.register_worker("remote-w")
        item = client.request_work("remote-w")
        assert item is not None
        pq_after_pop = len(coord.priority_queue)
        assert client.fail_work("remote-w", item.work_id) is True
        assert len(coord.priority_queue) == pq_after_pop + 1
        assert client.fail_work("remote-w", item.work_id) is False
        client.shutdown()
    finally:
        coord.shutdown()
        srv.shutdown()
        service.shutdown()


def test_options_204_no_body(server):
    """RFC 9110: 204 must carry no content (a body would desync the
    keep-alive connection for the next request / CORS preflight)."""
    import http.client
    url, _ = server
    host, port = url.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=5)
    conn.request("OPTIONS", "/health")
    r = conn.getresponse()
    assert r.status == 204
    assert r.read() == b""
    assert r.getheader("Content-Length") in (None, "0")
    # connection still usable for the next request (no desync)
    conn.request("GET", "/ping")
    r2 = conn.getresponse()
    assert r2.status == 200
    r2.read()
    conn.close()


def test_coordination_missing_field_is_400(graph, store):
    """A POST body missing a required field is the client's error: 400 with
    a named field, not a 500."""
    from rad_tpu.service.local import LocalHNSWService

    service = LocalHNSWService(graph, store)
    coord = CoordinationService(service, heartbeat_interval=0.5)
    srv, app = create_hnsw_server(graph, host="127.0.0.1", port=0,
                                  smiles_store=store, coordination=coord)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        import json as _json
        import urllib.request
        req = urllib.request.Request(
            f"{url}/coordination/heartbeat",
            data=_json.dumps({}).encode(),   # no worker_id
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            urllib.request.urlopen(req, timeout=5)
            assert False, "expected HTTP 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
            detail = _json.loads(e.read().decode())["detail"]
            assert "worker_id" in detail
    finally:
        coord.shutdown()
        srv.shutdown()
        service.shutdown()


def test_homepage_html_for_browsers(server):
    """'/' serves the homepage to browsers (Accept: text/html) and JSON to
    API clients — parity with the reference's index.html at '/'."""
    import urllib.request
    url, _ = server
    req = urllib.request.Request(url + "/",
                                 headers={"Accept": "text/html"})
    with urllib.request.urlopen(req, timeout=5) as r:
        body = r.read().decode()
        assert r.headers.get_content_type() == "text/html"
    assert "<html" in body and "Tanimoto" in body
    with urllib.request.urlopen(url + "/", timeout=5) as r:
        assert r.headers.get_content_type() == "application/json"


def test_query_string_routes_and_health_probe(server):
    """Routes match the bare path: '/health?probe=1' (load balancers
    append query params) must hit /health, not 404 (regression: routing
    compared the raw request path including the query string)."""
    import json
    from urllib.request import urlopen

    url, _ = server
    with urlopen(f"{url}/health?probe=1", timeout=10) as r:
        assert r.status == 200
        assert json.loads(r.read())["status"] == "healthy"
    with urlopen(f"{url}/top-level-nodes?x=y", timeout=10) as r:
        assert r.status == 200


def test_info_caches_smiles_db_size(server, store):
    """/info counts the SMILES store once (COUNT(*) is a full scan at
    serving scale), then serves the cached figure."""
    import json
    from urllib.request import urlopen

    url, app = server
    with urlopen(f"{url}/info", timeout=10) as r:
        size1 = json.loads(r.read())["smiles_db_size"]
    assert size1 == len(store)
    assert app._smiles_db_size == size1
    app._smiles_db_size = size1 + 123  # detect a recount
    with urlopen(f"{url}/info", timeout=10) as r:
        assert json.loads(r.read())["smiles_db_size"] == size1 + 123


@pytest.mark.parametrize("status", [429, 503])
def test_client_retries_throttling_and_server_errors(status):
    """429 and 5xx answers are retried with backoff; the request then
    succeeds on the first good answer, with auth and body sent each try."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen = []

    class Flaky(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            seen.append((self.headers.get("Authorization"), body))
            code = status if len(seen) < 3 else 200
            payload = json.dumps({"ok": code == 200}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Flaky)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        svc = RemoteHNSWService(f"http://127.0.0.1:{srv.server_address[1]}",
                                api_key="k", max_retries=3,
                                backoff_factor=0.01)
        out = svc._request("POST", "/x", {"a": 1})
        assert out == {"ok": True}
        assert seen == [("Bearer k", {"a": 1})] * 3
        assert svc._error_count == 2
        # out of retries: a ConnectionError names the last status
        seen.clear()
        svc.max_retries = 1
        with pytest.raises(ConnectionError, match=str(status)):
            svc._request("POST", "/x", {"a": 1})
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
