"""Remote-proving dispatcher backend.

The TPU-native analog of the reference's off-machine proving services —
Bonsai for risc0 (provers/risc0/driver/src/bonsai.rs:195-226: upload,
create_session, poll every 15s, cancel via the persisted session id) and
the SP1 network (provers/sp1/driver/src/lib.rs:58-112: create_proof /
poll / unclaim-cancel).  Here the "proving network" is simply another
raiko-tpu host: the request is forwarded over the v2 API, the session
(endpoint + request body) is persisted through the task manager's
IdStore (reference lib/src/prover.rs:41-50), the driver polls by
re-POSTing (the v2 state machine IS the polling protocol), and
cancel-by-id POSTs /v2/proof/cancel on the remote host.

Config keys (flat, in prover_args):
  endpoint           http://host:port of the remote raiko-tpu host (required)
  remote_proof_type  backend the REMOTE host runs (default "native")
  remote_args        extra request-config forwarded verbatim
  poll_interval      seconds between polls (default 0.5; reference: 15)
  poll_timeout       give up after this many seconds (default 600)
  jwt                bearer token for the remote host, if it requires auth

The returned proof is the remote backend's artifact; its ``input`` field
is cross-checked against the locally computed instance hash — the same
expected-output check the reference applies to Bonsai receipts
(bonsai.rs:155-176).

Port of raiko_tpu/provers/remote.py, copied whole: it has no device work,
and it forwards to another of the port's servers."""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request

from ..core.interfaces import GuestError, Proof, ProofType, RpcError
from .base import Prover, ProverCtx, register

log = logging.getLogger("raiko.remote")


class RemoteCancelled(GuestError):
    kind = "remote_cancelled"


class RemoteProver(Prover):
    proof_type = ProofType.REMOTE

    def __init__(self):
        # live sessions for cancel-by-key when no IdStore is provided
        self._sessions: dict = {}
        self._cancelled: set = set()
        self._lock = threading.Lock()

    # -- driver ----------------------------------------------------------
    def run(self, guest_input, output, config: dict, ctx=None) -> Proof:
        ctx = ctx or ProverCtx()
        endpoint = config.get("endpoint")
        if not endpoint:
            raise GuestError("remote prover requires an 'endpoint' config key")
        inner = str(config.get("remote_proof_type", "native"))
        req = ctx.request
        body = {
            "proof_type": inner,
            **(config.get("remote_args") or {}),
        }
        if req is not None:
            body.update(
                block_number=req.block_number,
                network=req.network,
                l1_network=req.l1_network,
                prover=req.prover,
                graffiti=req.graffiti,
                blob_proof_type=req.blob_proof_type,
            )
        else:  # direct invocation without a ProofRequest: prove by block
            body.setdefault("block_number", int(guest_input.block_header.number))
            body.setdefault("network", guest_input.chain_spec.name)
        session = {"endpoint": endpoint.rstrip("/"), "body": body}
        skey = self._session_key(ctx.key, session)
        # persist the session id (ref lib/src/prover.rs:41-50) so a
        # restarted host can still cancel the remote task
        if ctx.id_store is not None and ctx.key is not None:
            ctx.id_store.store_id(ctx.key, json.dumps(session))
        with self._lock:
            self._sessions[skey] = session
            self._cancelled.discard(skey)
        try:
            return self._poll(session, skey, output, config, ctx)
        finally:
            with self._lock:
                self._sessions.pop(skey, None)
            if ctx.id_store is not None and ctx.key is not None:
                ctx.id_store.remove_id(ctx.key)

    def _poll(self, session, skey, output, config: dict, ctx) -> Proof:
        """Enqueue-or-poll loop (the reference polls Bonsai every 15s,
        bonsai.rs:203-226; our v2 POST both enqueues and polls)."""
        interval = float(config.get("poll_interval", 0.5))
        deadline = time.monotonic() + float(config.get("poll_timeout", 600))
        jwt = config.get("jwt")
        while True:
            if self._is_cancelled(skey) or (
                ctx.cancel_ev is not None and ctx.cancel_ev.is_set()
            ):
                self._post(session, "/v2/proof/cancel", jwt)
                raise RemoteCancelled("remote proving session cancelled")
            if time.monotonic() > deadline:
                self._post(session, "/v2/proof/cancel", jwt)
                raise RpcError("remote proving timed out")
            resp = self._post(session, "/v2/proof", jwt)
            if resp is None:
                time.sleep(interval)
                continue
            if resp.get("status") == "error":
                raise GuestError(
                    f"remote host error: {resp.get('error')}: {resp.get('message')}"
                )
            data = resp.get("data") or {}
            status = data.get("status")
            if status == "work_in_progress" or status == "registered":
                time.sleep(interval)
                continue
            if "proof" in data:
                return self._accept(data["proof"], output)
            # failed / cancelled on the remote: the v2 handler re-enqueues
            # on the next POST, so a terminal failure loops forever unless
            # we bail here
            raise GuestError(f"remote proving failed with status {status!r}")

    def _accept(self, proof_json: dict, output) -> Proof:
        got = proof_json.get("input")
        expect = "0x" + output.hash.hex()
        if got != expect:
            # the expected-output check the reference applies to Bonsai
            # receipts (bonsai.rs:155-176)
            raise GuestError(
                f"remote proof bound to {got}, expected instance {expect}"
            )
        return Proof(
            proof=proof_json.get("proof"),
            input_hash=got,
            quote=proof_json.get("quote"),
            kzg_proof=proof_json.get("kzg_proof"),
            uuid=proof_json.get("uuid"),
        )

    # -- cancellation ----------------------------------------------------
    def cancel(self, key, id_store=None) -> None:
        """Cancel by task key: flag the live poll loop (it POSTs the
        remote cancel itself) or, for a dead/restarted host, read the
        persisted session from the IdStore and cancel directly."""
        session = None
        with self._lock:
            for skey, s in self._sessions.items():
                if skey[0] == key or skey == self._session_key(key, s):
                    self._cancelled.add(skey)
                    return
        if id_store is not None and key is not None:
            sid = id_store.read_id(key)
            if sid:
                try:
                    session = json.loads(sid)
                except ValueError:
                    session = None
        if session:
            self._post(session, "/v2/proof/cancel", None)
            id_store.remove_id(key)

    def _is_cancelled(self, skey) -> bool:
        with self._lock:
            return skey in self._cancelled

    @staticmethod
    def _session_key(key, session):
        if key is not None:
            return (key, None)
        return (None, session["endpoint"] + json.dumps(session["body"], sort_keys=True))

    # -- http ------------------------------------------------------------
    @staticmethod
    def _post(session, path: str, jwt: str | None):
        url = session["endpoint"] + path
        req = urllib.request.Request(
            url,
            data=json.dumps(session["body"]).encode(),
            headers={
                "content-type": "application/json",
                **({"authorization": f"Bearer {jwt}"} if jwt else {}),
            },
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read())
            except Exception:
                raise RpcError(f"remote host HTTP {e.code} at {url}") from None
        except (urllib.error.URLError, OSError) as e:
            raise RpcError(f"remote host unreachable at {url}: {e}") from None


register(RemoteProver())
