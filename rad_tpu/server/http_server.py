"""HTTP façade over an HNSW graph (+ optional coordination endpoints).

Parity surface with the reference's FastAPI server (rad/hnsw_server.py):

  GET /                    service homepage (JSON here)
  GET /ping                liveness
  GET /health              health + index reachability
  GET /info                index metadata + server metrics
  GET /neighbors/{id}/{lvl} neighbor [id, smiles, ...] pairs (400 on invalid)
  GET /top-level-nodes     top-layer [id, smiles, ...] (persistent JSON cache
                           keyed by an MD5 of levels_stats — reference
                           rad/hnsw_server.py:144-247)

plus Bearer-token auth (:419-431), CORS headers (:358-365), per-request
UUIDs in an ``X-Request-ID`` response header (:367-402), and endpoint
metrics (:46-84). Implemented on the stdlib ``ThreadingHTTPServer`` — this
image has no FastAPI/uvicorn, and a dependency-free server is the sturdier
deployment story anyway.

Beyond parity, the server optionally exposes the *coordination* API
(``/coordination/...``) so scoring workers on other machines can join a
traversal over plain HTTP — the replacement for the reference's
"share one Redis" multi-node recipe (README.md:120-129).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from rad_tpu.graph.storage import HNSWGraph, host_keys_view
from rad_tpu.store.smiles_store import SmilesStore

logger = logging.getLogger(__name__)

__all__ = ["HNSWServerMetrics", "HNSWServerApp", "create_hnsw_server",
           "run_hnsw_server"]


class HNSWServerMetrics:
    """Request counters + latency (parity with rad/hnsw_server.py:46-84)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.started_at = time.time()
        self.total_requests = 0
        self.total_errors = 0
        self.total_latency = 0.0
        self.by_endpoint: Dict[str, int] = {}

    def record_request(self, endpoint: str, latency: float,
                       error: bool = False) -> None:
        with self._lock:
            self.total_requests += 1
            self.total_latency += latency
            self.by_endpoint[endpoint] = self.by_endpoint.get(endpoint, 0) + 1
            if error:
                self.total_errors += 1

    def get_stats(self) -> dict:
        with self._lock:
            uptime = time.time() - self.started_at
            reqs = self.total_requests
            return {
                "uptime_seconds": uptime,
                "total_requests": reqs,
                "total_errors": self.total_errors,
                "success_rate": (reqs - self.total_errors) / max(reqs, 1),
                "avg_latency_ms": 1000.0 * self.total_latency / max(reqs, 1),
                "requests_per_second": reqs / max(uptime, 1e-9),
                "requests_by_endpoint": dict(self.by_endpoint),
            }


class HNSWServerApp:
    """The application object: routes + index + caches + metrics."""

    def __init__(
        self,
        graph: HNSWGraph,
        smiles_store: Optional[SmilesStore] = None,
        api_key: Optional[str] = None,
        enable_cors: bool = False,
        cache_dir: Optional[str] = None,
        coordination=None,
        static_dir: Optional[str] = None,
        server_name: str = "rad-tpu-hnsw",
    ) -> None:
        self.graph = graph
        self.smiles_store = smiles_store
        self.api_key = api_key
        self.enable_cors = enable_cors
        self.cache_dir = cache_dir
        self.coordination = coordination
        self.static_dir = os.path.abspath(static_dir) if static_dir else None
        self.server_name = server_name
        self.metrics = HNSWServerMetrics()
        self._keys = host_keys_view(graph.keys)
        self._top_cache: Optional[list] = None
        self._top_cache_lock = threading.Lock()
        # computed once on first /info: len(SQLiteSmilesStore) is a full
        # COUNT(*) scan — minutes per request at the 2B serving scale
        self._smiles_db_size: Optional[int] = None

    # ------------------------------------------------------------- helpers
    def _smiles_pairs(self, ids) -> list:
        keys = [int(self._keys[i]) for i in ids]
        found = (self.smiles_store.get_smiles_batch(keys)
                 if self.smiles_store is not None else {})
        out: list = []
        for i, k in zip(ids, keys):
            out.extend((int(i), found.get(k, "")))
        return out

    def _levels_fingerprint(self) -> str:
        """MD5 over levels_stats — cache key for the top-level-node cache
        (reference rad/hnsw_server.py:144-247)."""
        stats = [(s.nodes, s.edges, s.max_edges)
                 for s in self.graph.levels_stats()]
        return hashlib.md5(json.dumps(stats).encode()).hexdigest()

    def top_level_nodes(self) -> list:
        with self._top_cache_lock:
            if self._top_cache is not None:
                return self._top_cache
            cache_file = None
            if self.cache_dir:
                os.makedirs(self.cache_dir, exist_ok=True)
                cache_file = os.path.join(
                    self.cache_dir,
                    f"top_nodes_{self._levels_fingerprint()}.json")
                if os.path.exists(cache_file):
                    try:
                        with open(cache_file) as f:
                            self._top_cache = json.load(f)
                        logger.info("top-level-node cache hit: %s", cache_file)
                        return self._top_cache
                    except Exception:
                        logger.exception("corrupt top-node cache; rebuilding")
            flat = self.graph.get_top_level_nodes()
            pairs = self._smiles_pairs(flat[0::2])
            self._top_cache = pairs
            if cache_file:
                tmp = cache_file + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(pairs, f)
                os.replace(tmp, cache_file)
            return self._top_cache

    def _homepage_html(self) -> bytes:
        """The public homepage (parity with the reference's index.html
        served at '/'). A static_dir index.html overrides the built-in."""
        if self.static_dir:
            custom = os.path.join(self.static_dir, "index.html")
            if os.path.isfile(custom):
                with open(custom, "rb") as f:
                    return f.read()
        info = self.graph.info()
        return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>{self.server_name}</title>
<style>
 body {{ font-family: system-ui, sans-serif; max-width: 46rem;
        margin: 3rem auto; padding: 0 1rem; color: #222; }}
 code, pre {{ background: #f4f4f4; padding: .15rem .35rem;
             border-radius: 4px; }}
 table {{ border-collapse: collapse; }} td, th {{ padding: .25rem .7rem;
 border-bottom: 1px solid #ddd; text-align: left; }}
</style></head><body>
<h1>{self.server_name}</h1>
<p>A retrieval-augmented-screening index service: an HNSW
graph over packed binary molecular fingerprints with a Tanimoto metric,
traversed best-first by docking (or ML) score so that only a small
fraction of an ultra-large library ever needs scoring.</p>
<table>
<tr><th>molecules</th><td>{info['size']:,}</td></tr>
<tr><th>fingerprint bits</th><td>{info['ndim']}</td></tr>
<tr><th>connectivity</th><td>{info['connectivity']}</td></tr>
<tr><th>levels</th><td>{info['max_level'] + 1}</td></tr>
</table>
<h2>API</h2>
<ul>
<li><code>GET /health</code>, <code>GET /ping</code>, <code>GET /info</code></li>
<li><code>GET /neighbors/{{node_id}}/{{level}}</code> — adjacency with SMILES</li>
<li><code>GET /top-level-nodes</code> — traversal seeds</li>
</ul>
<p>Client: <code>rad_tpu.service.remote.RemoteHNSWService(url)</code> —
drop-in for the local service in any <code>RADTraverser</code>.</p>
</body></html>""".encode()

    # -------------------------------------------------------------- routes
    def handle(self, method: str, path: str, body: Optional[dict],
               headers) -> Tuple[int, dict]:
        """Dispatch; returns (status_code, json_payload)."""
        # routes match the bare path: '/health?probe=1' must hit /health
        # (load balancers and compatible clients append query params)
        path = path.split("?", 1)[0]
        if self.api_key is not None and path not in ("/", "/ping"):
            auth = headers.get("Authorization", "")
            if auth != f"Bearer {self.api_key}":
                return 401, {"detail": "invalid or missing API key"}

        if method == "GET":
            if path == "/" :
                # browsers get a homepage (reference serves index.html at
                # '/', rad/hnsw_server.py:436-445); API clients get JSON
                accept = (headers.get("Accept") or "")
                if "text/html" in accept:
                    return 200, {"__raw__": self._homepage_html(),
                                 "__path__": "index.html"}
                return 200, {
                    "service": self.server_name,
                    "description": "HNSW index service "
                                   "(rad_tpu)",
                    "endpoints": ["/ping", "/health", "/info",
                                  "/neighbors/{node_id}/{level}",
                                  "/top-level-nodes"],
                }
            if path == "/ping":
                return 200, {"status": "ok"}
            if path == "/health":
                try:
                    _ = len(self.graph)
                    return 200, {"status": "healthy",
                                 "index_size": len(self.graph),
                                 "pid": os.getpid(),
                                 "has_smiles_db":
                                     self.smiles_store is not None}
                except Exception as e:
                    return 503, {"status": "unhealthy", "detail": str(e)}
            if path == "/info":
                if self._smiles_db_size is None:
                    # store is immutable while serving (same reasoning as
                    # the levels_stats cache); count it once
                    self._smiles_db_size = (len(self.smiles_store)
                                            if self.smiles_store else 0)
                return 200, {
                    "hnsw": self.graph.info(),
                    "levels_stats": [vars(s)
                                     for s in self.graph.levels_stats()],
                    "metrics": self.metrics.get_stats(),
                    "smiles_db_size": self._smiles_db_size,
                }
            if path == "/top-level-nodes":
                pairs = self.top_level_nodes()
                return 200, {"nodes": pairs,
                             "node_count": len(pairs) // 2}
            m = re.fullmatch(r"/neighbors/(-?\d+)/(-?\d+)", path)
            if m:
                node_id, level = int(m.group(1)), int(m.group(2))
                if not 0 <= node_id < len(self.graph):
                    return 400, {"detail": f"node_id {node_id} out of range "
                                           f"[0, {len(self.graph)})"}
                if not 0 <= level <= self.graph.max_level:
                    return 400, {"detail": f"level {level} out of range "
                                           f"[0, {self.graph.max_level}]"}
                try:
                    flat = self.graph.get_neighbors(node_id, level)
                except ValueError as e:
                    return 400, {"detail": str(e)}
                pairs = self._smiles_pairs(flat[0::2])
                return 200, {"node_id": node_id, "level": level,
                             "neighbors": pairs,
                             "neighbor_count": len(pairs) // 2}

        if self.coordination is not None and path.startswith("/coordination/"):
            return self._handle_coordination(method, path, body)

        if (self.static_dir and method == "GET"
                and path.startswith("/static/")):
            # static homepage assets (reference rad/hnsw_server.py:621-635)
            target = os.path.abspath(
                os.path.join(self.static_dir, path[len("/static/"):]))
            if not target.startswith(self.static_dir + os.sep):
                return 403, {"detail": "path escapes static root"}
            if os.path.isfile(target):
                with open(target, "rb") as f:
                    return 200, {"__raw__": f.read(), "__path__": target}
            return 404, {"detail": "not found"}

        return 404, {"detail": f"no route for {method} {path}"}

    # -------------------------------------------- coordination (distributed)
    def _handle_coordination(self, method: str, path: str,
                             body: Optional[dict]) -> Tuple[int, dict]:
        coord = self.coordination
        try:
            return self._dispatch_coordination(coord, method, path, body)
        except KeyError as e:
            # missing required field in the POST body is the client's
            # fault, not a server bug: 400, not 500
            return 400, {"detail": f"missing field {e} in request body"}

    def _dispatch_coordination(self, coord, method: str, path: str,
                               body):
        body = body or {}
        if method == "POST" and path == "/coordination/register":
            wid = body.get("worker_id") or f"http-{uuid.uuid4().hex[:8]}"
            return 200, coord.register_worker(wid)
        if method == "POST" and path == "/coordination/heartbeat":
            ok = coord.worker_heartbeat(body["worker_id"])
            return 200, {"ok": bool(ok)}
        if method == "POST" and path == "/coordination/request-work":
            item = coord.request_work(body["worker_id"])
            return 200, {"work": item.to_dict() if item else None}
        if method == "POST" and path == "/coordination/submit-results":
            ok = coord.submit_work_results(
                body["worker_id"], body["work_id"],
                [(int(i), float(s), str(sm))
                 for i, s, sm in body.get("results", [])])
            return 200, {"ok": bool(ok)}
        if method == "POST" and path == "/coordination/error":
            coord.report_worker_error(body["worker_id"],
                                      body.get("error", ""))
            return 200, {"ok": True}
        if method == "POST" and path == "/coordination/fail":
            ok = coord.fail_work(body["worker_id"], body["work_id"])
            return 200, {"ok": bool(ok)}
        m = re.fullmatch(r"/coordination/score/(-?\d+)", path)
        if m and method == "GET":
            return 200, {"score": coord.scored_set.getScore(int(m.group(1)))}
        if method == "POST" and path == "/coordination/scores":
            ids = [int(i) for i in body.get("node_ids", [])]
            if hasattr(coord.scored_set, "get_scores_batch"):
                found = coord.scored_set.get_scores_batch(ids)
            else:
                found = {i: coord.scored_set.getScore(i) for i in ids}
            return 200, {"scores": {str(i): s for i, s in found.items()}}
        if method == "GET" and path == "/coordination/stats":
            return 200, coord.get_coordination_stats()
        return 404, {"detail": f"no coordination route {method} {path}"}


def _make_handler(app: HNSWServerApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # without this, keep-alive clients hit the Nagle x delayed-ACK
        # interaction: every response waits ~40 ms for the peer's ACK
        # (measured: p50 44 ms -> sub-ms; benchmarks/bench_serving.py)
        disable_nagle_algorithm = True

        def _respond(self, method: str) -> None:
            t0 = time.perf_counter()
            request_id = self.headers.get("X-Correlation-ID",
                                          str(uuid.uuid4()))
            body = None
            if method == "POST":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n)) if n else {}
                except Exception:
                    self._send(400, {"detail": "invalid JSON body"},
                               request_id)
                    return
            try:
                status, payload = app.handle(method, self.path, body,
                                             self.headers)
            except Exception as e:  # route bug — surface as 500
                logger.exception("unhandled error on %s %s", method,
                                 self.path)
                status, payload = 500, {"detail": str(e)}
            endpoint = self.path.split("?")[0]
            endpoint = re.sub(r"/-?\d+", "/{}", endpoint)
            app.metrics.record_request(endpoint, time.perf_counter() - t0,
                                       error=status >= 400)
            if isinstance(payload, dict):
                payload = dict(payload, request_id=request_id)
            self._send(status, payload, request_id)

        def _send(self, status: int, payload, request_id: str) -> None:
            if isinstance(payload, dict) and "__raw__" in payload:
                import mimetypes
                data = payload["__raw__"]
                ctype = mimetypes.guess_type(payload.get("__path__", ""))[0] \
                    or "application/octet-stream"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Request-ID", request_id)
                self.end_headers()
                self.wfile.write(data)
                return
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Request-ID", request_id)
            if app.enable_cors:
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Headers",
                                 "Authorization, Content-Type")
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            self._respond("GET")

        def do_POST(self):  # noqa: N802
            self._respond("POST")

        def do_OPTIONS(self):  # noqa: N802
            # RFC 9110: 204 carries NO content — a body would desync this
            # keep-alive connection for the next request (CORS preflight)
            self.send_response(204)
            self.send_header("X-Request-ID", str(uuid.uuid4()))
            self.send_header("Allow", "GET, POST, OPTIONS")
            if app.enable_cors:
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Methods",
                                 "GET, POST, OPTIONS")
                self.send_header("Access-Control-Allow-Headers",
                                 "Authorization, Content-Type")
            self.end_headers()

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("%s - %s", self.address_string(), fmt % args)

    return Handler


class _ReusePortHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer binding with SO_REUSEPORT: N server processes
    share one port and the kernel load-balances accept() across them —
    the stdlib-server analogue of the reference CLI's uvicorn
    ``--workers`` flag (/root/reference/scripts/start_hnsw_server.py).
    Each process mmaps the same graph file, so the page cache is shared."""

    def server_bind(self):
        import socket
        if hasattr(socket, "SO_REUSEPORT"):  # pragma: no branch - linux
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def create_hnsw_server(graph: HNSWGraph, host: str = "127.0.0.1",
                       port: int = 8000, reuse_port: bool = False, **kwargs):
    """Build a ThreadingHTTPServer serving ``graph``
    (parity with rad/hnsw_server.py:638). Returns (server, app).
    Port 0 binds an ephemeral port (server.server_address[1]).
    ``reuse_port`` binds with SO_REUSEPORT so multiple worker processes
    can share the port (see :class:`_ReusePortHTTPServer`)."""
    app = HNSWServerApp(graph, **kwargs)
    cls = _ReusePortHTTPServer if reuse_port else ThreadingHTTPServer
    server = cls((host, port), _make_handler(app))
    server.daemon_threads = True
    return server, app


def run_hnsw_server(graph: HNSWGraph, host: str = "0.0.0.0",
                    port: int = 8000, reuse_port: bool = False,
                    **kwargs) -> None:
    """Blocking serve loop (parity with rad/hnsw_server.py:652)."""
    server, _ = create_hnsw_server(graph, host, port,
                                   reuse_port=reuse_port, **kwargs)
    logger.info("serving HNSW index (%d nodes) on %s:%d", len(graph), host,
                server.server_address[1])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
