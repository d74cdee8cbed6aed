"""HTTP proof service (reference host/src/server/).

Routes (mirroring the reference's axum routers, api/mod.rs:22-58):

v1 (blocking):
  POST /v1/proof      — run the whole pipeline inline, return the proof
  GET  /v1/health     — liveness
  GET  /v1/metrics    — prometheus text

v2 (enqueue + poll; also mounted at the root like the reference):
  POST /v2/proof         — enqueue-or-poll state machine (v2/proof/mod.rs:34-102)
  POST /v2/proof/cancel  — cancel a running/enqueued task
  GET  /v2/proof/report  — all tasks + latest status
  POST /v2/proof/prune   — clear the task DB
  GET  /v2/docs/openapi.json — OpenAPI document

Optional JWT bearer auth (HS256, like the reference's jwt layer); errors
follow the reference's {"status":"error","error","message"} shape
(host/src/interfaces.rs:75-101)."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging

from aiohttp import web

from ..core.interfaces import InvalidRequestConfig, ProofRequest, RaikoError, merge_json
from ..tasks import TaskStatus
from ..utils.measurement import Measurement
from . import metrics
from .actor import ProofActor, make_task_descriptor


def _ok(data) -> web.Response:
    return web.json_response({"status": "ok", "data": data})


def _err(error: str, message: str, http=400) -> web.Response:
    return web.json_response(
        {"status": "error", "error": error, "message": message}, status=http
    )


def _status_json(status: TaskStatus) -> dict:
    return {"status": status.wire}


def create_app(actor: ProofActor) -> web.Application:
    app = web.Application(middlewares=[_cors_middleware])
    app["actor"] = actor
    if actor.config.jwt_secret:
        app.middlewares.append(_jwt_middleware(actor.config.jwt_secret))

    # v1
    app.router.add_post("/v1/proof", handle_v1_proof)
    app.router.add_get("/v1/health", handle_health)
    app.router.add_get("/v1/metrics", handle_metrics)
    # v2 + root mount (reference mounts v2 at / as well)
    for prefix in ("/v2", ""):
        app.router.add_post(f"{prefix}/proof", handle_v2_proof)
        app.router.add_post(f"{prefix}/proof/cancel", handle_v2_cancel)
        app.router.add_get(f"{prefix}/proof/report", handle_v2_report)
        app.router.add_post(f"{prefix}/proof/prune", handle_v2_prune)
        app.router.add_get(f"{prefix}/docs/openapi.json", handle_openapi)
        app.router.add_get(f"{prefix}/docs", handle_docs_ui)
    app.router.add_get("/health", handle_health)
    return app


@web.middleware
async def _cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        try:
            resp = await handler(request)
        except web.HTTPException:
            raise
        except RaikoError as e:
            resp = _err(e.kind, str(e), 500)
        except Exception as e:  # ref HostError::Anyhow -> JSON error shape
            logging.getLogger("raiko.http").exception("unhandled handler error")
            resp = _err("unhandled", f"{type(e).__name__}: {e}", 500)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Headers"] = "authorization, content-type"
    return resp


def _jwt_middleware(secret: str):
    @web.middleware
    async def mw(request: web.Request, handler):
        if request.path in ("/v1/health", "/health", "/v1/metrics"):
            return await handler(request)
        auth = request.headers.get("Authorization", "")
        if not auth.startswith("Bearer ") or not _verify_jwt(auth[7:], secret):
            return _err("unauthorized", "missing or invalid bearer token", 401)
        return await handler(request)

    return mw


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _verify_jwt(token: str, secret: str) -> bool:
    """Minimal HS256 JWT check (signature only, like the reference's
    jwt-authorizer default)."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        if header.get("alg") != "HS256":
            return False
        expect = hmac.new(
            secret.encode(),
            f"{header_b64}.{payload_b64}".encode(),
            hashlib.sha256,
        ).digest()
        return hmac.compare_digest(expect, _b64url_decode(sig_b64))
    except Exception:
        return False


def make_jwt(secret: str, payload: dict | None = None) -> str:
    """Token helper (tests / clients)."""

    def enc(obj) -> str:
        return base64.urlsafe_b64encode(json.dumps(obj).encode()).decode().rstrip("=")

    head = enc({"alg": "HS256", "typ": "JWT"})
    body = enc(payload or {})
    sig = hmac.new(secret.encode(), f"{head}.{body}".encode(), hashlib.sha256).digest()
    return f"{head}.{body}." + base64.urlsafe_b64encode(sig).decode().rstrip("=")


async def _parse_request(request: web.Request) -> ProofRequest:
    actor: ProofActor = request.app["actor"]
    try:
        body = await request.json()
    except Exception:
        body = {}
    merged = merge_json(actor.config.default_request, body or {})
    return ProofRequest.from_opt(merged)


async def handle_health(request: web.Request) -> web.Response:
    return web.json_response({})


async def handle_metrics(request: web.Request) -> web.Response:
    return web.Response(body=metrics.render(), content_type="text/plain")


async def handle_v1_proof(request: web.Request) -> web.Response:
    """Blocking prove (reference api/v1/proof.rs:30-57)."""
    import asyncio

    actor: ProofActor = request.app["actor"]
    try:
        req = await _parse_request(request)
    except InvalidRequestConfig as e:
        return _err("invalid_request_config", str(e))
    metrics.HOST_REQ_COUNT.labels(str(req.block_number)).inc()
    try:
        import threading

        proof_bytes = await asyncio.get_event_loop().run_in_executor(
            None, actor._handle_proof, req, threading.Event()
        )
        return _ok(json.loads(proof_bytes))
    except RaikoError as e:
        metrics.HOST_ERROR_COUNT.labels(str(req.block_number)).inc()
        return _err(e.kind, str(e), 500)


async def handle_v2_proof(request: web.Request) -> web.Response:
    """Enqueue-or-poll (reference api/v2/proof/mod.rs:34-102).  The answer,
    once the task's key and history are known, is a ``service.submit``
    span where it enqueues the task (or re-enqueues a failed one) and a
    ``service.poll`` span otherwise: the span opens after the handler's
    last ``await``."""
    import asyncio

    actor: ProofActor = request.app["actor"]
    try:
        req = await _parse_request(request)
    except InvalidRequestConfig as e:
        return _err("invalid_request_config", str(e))
    metrics.HOST_REQ_COUNT.labels(str(req.block_number)).inc()
    try:
        key = await asyncio.get_event_loop().run_in_executor(
            None, make_task_descriptor, req, actor.chain_specs
        )
    except RaikoError as e:
        metrics.HOST_ERROR_COUNT.labels(str(req.block_number)).inc()
        return _err(e.kind, str(e), 500)
    history = actor.tasks.get_task_proving_status(key)
    status = history[-1][0] if history else None
    if status in (TaskStatus.SUCCESS, TaskStatus.REGISTERED, TaskStatus.WORK_IN_PROGRESS):
        with Measurement("service.poll"):
            if status != TaskStatus.SUCCESS:
                return _ok(_status_json(status))
            proof = json.loads(actor.tasks.get_task_proof(key))
            return _ok({"proof": proof, **_status_json(status)})
    with Measurement("service.submit"):
        if history:
            # failed/cancelled: re-enqueue (ref v2/proof/mod.rs:77-92)
            actor.tasks.update_task_progress(key, TaskStatus.REGISTERED)
        else:
            actor.tasks.enqueue_task(key)
        actor.submit(key, req)
        return _ok(_status_json(TaskStatus.REGISTERED))


async def handle_v2_cancel(request: web.Request) -> web.Response:
    import asyncio

    actor: ProofActor = request.app["actor"]
    try:
        req = await _parse_request(request)
        key = await asyncio.get_event_loop().run_in_executor(
            None, make_task_descriptor, req, actor.chain_specs
        )
    except RaikoError as e:
        return _err(e.kind, str(e), 500)
    actor.cancel(key)
    return _ok(None)


async def handle_v2_report(request: web.Request) -> web.Response:
    actor: ProofActor = request.app["actor"]
    tasks = actor.tasks.list_all_tasks()
    return web.json_response(
        [
            [
                {
                    "chain_id": k.chain_id,
                    "blockhash": "0x" + k.blockhash.hex(),
                    "proof_system": k.proof_system,
                    "prover": k.prover,
                },
                s.wire,
            ]
            for k, s in tasks
        ]
    )


async def handle_v2_prune(request: web.Request) -> web.Response:
    actor: ProofActor = request.app["actor"]
    actor.tasks.prune_db()
    return _ok(None)


async def handle_openapi(request: web.Request) -> web.Response:
    return web.json_response(OPENAPI)


async def handle_docs_ui(request: web.Request) -> web.Response:
    """Interactive API docs at /v2/docs (reference serves Swagger +
    Scalar UIs, api/v2/mod.rs:146-157).  Self-contained HTML — no CDN
    assets, so it renders in air-gapped deployments — that fetches the
    OpenAPI JSON and provides a try-it-out POST console per route."""
    return web.Response(body=DOCS_HTML, content_type="text/html")


DOCS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>raiko-tpu API docs</title>
<style>
 body{font:15px/1.5 system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1a1d21}
 header{background:#101828;color:#fff;padding:18px 28px}
 header h1{margin:0;font-size:20px} header p{margin:4px 0 0;color:#98a2b3}
 main{max-width:900px;margin:24px auto;padding:0 16px}
 .op{background:#fff;border:1px solid #e4e7ec;border-radius:8px;margin:12px 0;overflow:hidden}
 .op>summary{padding:10px 14px;cursor:pointer;display:flex;gap:12px;align-items:center}
 .m{font-weight:700;font-size:12px;padding:3px 10px;border-radius:4px;color:#fff;min-width:44px;text-align:center}
 .m.get{background:#2e90fa}.m.post{background:#12b76a}
 .path{font-family:ui-monospace,monospace}.sum{color:#667085}
 .body{padding:12px 14px;border-top:1px solid #e4e7ec}
 textarea{width:100%;box-sizing:border-box;font-family:ui-monospace,monospace;font-size:13px;min-height:84px}
 button{background:#101828;color:#fff;border:0;border-radius:6px;padding:7px 16px;cursor:pointer;margin-top:6px}
 pre{background:#101828;color:#d0ffd8;padding:10px;border-radius:6px;overflow:auto;max-height:320px;font-size:12.5px}
</style></head><body>
<header><h1 id="t">raiko-tpu</h1><p id="d"></p></header><main id="ops"></main>
<script>
fetch(document.location.pathname.replace(/\\/docs$/,'/docs/openapi.json'))
 .then(r=>r.json()).then(spec=>{
  document.getElementById('t').textContent=spec.info.title+' '+spec.info.version;
  document.getElementById('d').textContent=spec.info.description||'';
  const main=document.getElementById('ops');
  for(const [path,methods] of Object.entries(spec.paths)){
   for(const [method,op] of Object.entries(methods)){
    const det=document.createElement('details');det.className='op';
    det.innerHTML=`<summary><span class="m ${method}">${method.toUpperCase()}</span>`+
     `<span class="path">${path}</span><span class="sum">${op.summary||''}</span></summary>`;
    const body=document.createElement('div');body.className='body';
    if(method==='post'){
     const ta=document.createElement('textarea');ta.value='{}';body.appendChild(ta);
     const b=document.createElement('button');b.textContent='Send';body.appendChild(b);
     const pre=document.createElement('pre');pre.textContent='';body.appendChild(pre);
     b.onclick=()=>fetch(path,{method:'POST',headers:{'content-type':'application/json'},body:ta.value})
      .then(r=>r.text()).then(t=>{try{pre.textContent=JSON.stringify(JSON.parse(t),null,1)}catch(e){pre.textContent=t}});
    }else{
     const b=document.createElement('button');b.textContent='Send';body.appendChild(b);
     const pre=document.createElement('pre');body.appendChild(pre);
     b.onclick=()=>fetch(path).then(r=>r.text()).then(t=>{try{pre.textContent=JSON.stringify(JSON.parse(t),null,1)}catch(e){pre.textContent=t}});
    }
    det.appendChild(body);main.appendChild(det);
   }}
 });
</script></body></html>"""


OPENAPI = {
    "openapi": "3.0.0",
    "info": {
        "title": "raiko-tpu",
        "description": "TPU-native block prover (raiko-compatible API)",
        "version": "0.1.0",
    },
    "paths": {
        "/v1/proof": {"post": {"summary": "Blocking proof generation"}},
        "/v1/health": {"get": {"summary": "Liveness probe"}},
        "/v1/metrics": {"get": {"summary": "Prometheus metrics"}},
        "/v2/proof": {"post": {"summary": "Enqueue or poll a proof task"}},
        "/v2/proof/cancel": {"post": {"summary": "Cancel a proof task"}},
        "/v2/proof/report": {"get": {"summary": "List tasks and status"}},
        "/v2/proof/prune": {"post": {"summary": "Clear the task DB"}},
    },
}
