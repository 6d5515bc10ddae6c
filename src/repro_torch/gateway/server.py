"""Stdlib-only JSON HTTP front-end for the campaign gateway.

``http.server.ThreadingHTTPServer`` + hand-rolled routing — no web
framework enters the dependency set. The API surface:

    POST /campaigns                       submit a serialized CampaignSpec
                                          (dict body; optional "state" key
                                          resumes a campaign checkpoint)
    GET  /campaigns                       list the caller's campaigns
    GET  /campaigns/{id}/report           incremental versioned report
    POST /campaigns/{id}/structures       stream structures into a RUNNING
                                          campaign (bucket refresh applies)
    POST /campaigns/{id}/pause|resume|cancel
    POST /campaigns/{id}/checkpoint       campaign checkpoint (session-
                                          compatible schema)
    GET  /metrics                         gateway-wide metrics snapshot
    GET  /healthz                         liveness probe (no auth: load
                                          balancers carry no tokens)

Auth is token-per-tenant: construct with ``tokens={"s3cret": "alice"}``
and every request must carry ``Authorization: Bearer <token>``; the token
names the tenant, and a campaign owned by another tenant 404s (no
cross-tenant existence oracle). With no token table the server is open
and the tenant comes from the ``X-Tenant`` header (default "default") —
the single-user dev mode ``launch/serve.py --gateway`` starts with.

Every handler thread funnels into ``GatewayService``'s lock, which is the
point: the HTTP layer holds no state of its own and stays trivially
correct under concurrency.

A copy of the JAX package's ``repro.gateway.server`` (stdlib only there
too) over the port's ``GatewayService``.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from repro_torch.gateway.service import GatewayError, GatewayService

_CAMPAIGN = re.compile(r"^/campaigns/([A-Za-z0-9_.-]+)(?:/([a-z]+))?$")


class _Handler(BaseHTTPRequestHandler):
    # the gateway owns these (set by make_server)
    gateway: GatewayService = None
    tokens: Optional[Dict[str, str]] = None   # token -> tenant; None = open
    protocol_version = "HTTP/1.1"

    # -- plumbing ---------------------------------------------------------

    def log_message(self, fmt, *args):   # quiet: obs/ is the telemetry path
        pass

    def _send(self, status: int, body: dict):
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _tenant(self) -> Optional[str]:
        """Resolve the caller's tenant, or answer 401 and return None."""
        if self.tokens is None:
            return self.headers.get("X-Tenant", "default")
        auth = self.headers.get("Authorization", "")
        tok = auth[7:] if auth.startswith("Bearer ") else ""
        tenant = self.tokens.get(tok)
        if tenant is None:
            self._send(401, {"error": "missing or unknown bearer token"})
        return tenant

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n == 0:
            return {}
        try:
            return json.loads(self.rfile.read(n))
        except (ValueError, UnicodeDecodeError):
            raise GatewayError(400, "request body is not valid JSON")

    def _dispatch(self, method: str):
        path = self.path.split("?", 1)[0].rstrip("/")
        if method == "GET" and path == "/healthz":
            # liveness must not depend on auth — probes carry no tokens —
            # so this short-circuits before tenant resolution can 401
            self._send(200, self.gateway.health())
            return
        tenant = self._tenant()
        if tenant is None:
            return
        try:
            handled = self._route(method, tenant)
        except GatewayError as e:
            self._send(e.status, {"error": str(e)})
            return
        except (TypeError, ValueError, KeyError) as e:
            # bad specs surface as client errors, not connection resets
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
            return
        if not handled:
            self._send(404, {"error": f"no route {method} {self.path}"})

    # -- routing ----------------------------------------------------------

    def _route(self, method: str, tenant: str) -> bool:
        gw = self.gateway
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if method == "GET" and path == "/metrics":
            self._send(200, gw.metrics_snapshot())
            return True
        if path == "/campaigns":
            if method == "GET":
                self._send(200, {"campaigns": gw.list_campaigns(tenant)})
                return True
            if method == "POST":
                body = self._body()
                state = body.pop("state", None)
                cid = gw.submit_campaign(body, tenant=tenant, state=state)
                self._send(201, {"id": cid, "state": "RUNNING"})
                return True
            return False
        m = _CAMPAIGN.match(path)
        if not m:
            return False
        cid, verb = m.group(1), m.group(2)
        if method == "GET" and verb == "report":
            self._send(200, gw.report(cid, tenant=tenant))
            return True
        if method != "POST":
            return False
        if verb == "structures":
            self._send(200, gw.stream_structures(cid, self._body(),
                                                 tenant=tenant))
            return True
        if verb == "checkpoint":
            self._send(200, gw.checkpoint_campaign(cid, tenant=tenant))
            return True
        if verb in ("pause", "resume", "cancel"):
            getattr(gw, f"{verb}_campaign")(cid, tenant=tenant)
            self._send(200, {"id": cid,
                             "state": gw._get(cid, tenant).state.value})
            return True
        return False

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def make_server(gateway: GatewayService, host: str = "127.0.0.1",
                port: int = 0,
                tokens: Optional[Dict[str, str]] = None
                ) -> ThreadingHTTPServer:
    """Bind (but do not serve) the gateway's HTTP front-end. ``port=0``
    picks a free port — read it back from ``server.server_address``."""
    handler = type("GatewayHandler", (_Handler,),
                   {"gateway": gateway,
                    "tokens": dict(tokens) if tokens else None})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    return srv


def serve_forever(gateway: GatewayService, host: str = "127.0.0.1",
                  port: int = 8642,
                  tokens: Optional[Dict[str, str]] = None
                  ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Start the HTTP front-end on a daemon thread and return
    ``(server, thread)`` — the CLI's entry point."""
    srv = make_server(gateway, host, port, tokens)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread
