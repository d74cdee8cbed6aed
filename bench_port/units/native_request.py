"""Unit ``native_request``: one ``POST /v2/proof`` of proof type
``native`` to the port's proof service, polled to its end.

Set-up starts the service in this process (``host.cli.BackgroundServer``,
on a free local port, ``--device cuda``, no input cache), builds the
seed's blocks and sends one warm-up request for each of the first
``traffic["warm_requests"]`` blocks.  The window asks for the blocks in
turn, each request with a prover address and a graffiti that no earlier
request of the run had (drawn from the seed).  The service keys its tasks
by chain, block hash, proof type and prover address (the reference's
``TaskDescriptor``), so a new prover address makes every request do its
whole preflight, re-execution and KZG work; a new graffiti alone would be
answered from the task store.

The client re-sends the request every ``traffic["poll_s"]`` seconds until
the task is done, as a prover's client does.  The service shares this
process, so each poll's HTTP handling takes the interpreter from the
request's own host work: a short interval costs that, a long one adds
half an interval of waiting on average.  The window counts the polls and
the seconds their round trips took (``polls``, ``poll_s``).

The check: every served ``input`` equals the plain reference's instance
hash of its block, graffiti and prover, and every served ``kzg_proof`` of
a sample of the blocks drawn from the seed equals the reference's KZG
proof of the block's blob; the reference's trusted setup must keep the
published property that its G1 Lagrange points add up to the generator.
"""

from __future__ import annotations

import hashlib
import json
import random
import socket
import time
import urllib.request

from chain_mix import build_chain
from unit_base import UnitBase


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def histogram_totals(hist) -> tuple[float, float]:
    """(sum, count) of a prometheus histogram over all its labels."""
    total = count = 0.0
    for metric in hist.collect():
        for s in metric.samples:
            if s.name.endswith("_sum"):
                total += s.value
            elif s.name.endswith("_count"):
                count += s.value
    return total, count


class Unit(UnitBase):
    # control: each request sent with the previous request's prover and
    # graffiti (the answer binds another statement); stale: the previous
    # answer returned again; altered: one byte of the KZG proof changed
    faults = ("control", "stale", "altered")

    def setup(self) -> None:
        from raiko_tpu_torch import kernels
        from raiko_tpu_torch.host import metrics
        from raiko_tpu_torch.host.cli import BackgroundServer
        from raiko_tpu_torch.utils import native

        self.kernels, self.metrics, self.native = kernels, metrics, native
        self.port = free_port()
        argv = ["--device", self.device, "--address", "127.0.0.1", "--port", str(self.port), "--log-level", "warning"]
        self.server = BackgroundServer(argv)
        self.server.__enter__()
        self.base = f"http://127.0.0.1:{self.port}/v2/proof"
        t = self.traffic
        self.l2, _ = build_chain(self.seed, t["blocks"], t["txs_per_block"], t["mix"], t["contracts"],
                                 self.server.device, l1_network=self.settings["l1_network"])
        self.l1 = self.l2.l1
        self.hashes = ["0x" + self.l2.headers[b].hash().hex() for b in range(1, t["blocks"] + 1)]
        self.cycle = t["blocks"]
        self.request_seed = random.Random(self.seed ^ 0x6AFF).randbytes(16)
        self.served: list = []  # (block, prover, graffiti, answer)
        self.last = None
        self.polls, self.poll_s = 0, 0.0
        for blk in range(1, t["warm_requests"] + 1):
            self.ask(blk, *self.names(-blk))

    def describe(self) -> dict:
        return {"blocks": self.hashes, "poll_s": self.traffic["poll_s"]}

    def names(self, i: int) -> tuple[str, str]:
        """(prover address, graffiti) of the i-th request, from the seed."""
        h = hashlib.sha512(self.request_seed + i.to_bytes(8, "big", signed=True)).digest()
        return "0x" + h[:20].hex(), "0x" + h[32:].hex()

    def ask(self, blk: int, prover: str, graffiti: str) -> dict:
        body = {"block_number": blk, "network": self.settings["network"], "l1_network": self.settings["l1_network"],
                "proof_type": self.settings["proof_type"], "blob_proof_type": self.settings["blob_proof_type"],
                "prover": prover, "graffiti": graffiti}
        poll = self.traffic["poll_s"]
        r = post(self.base, body)
        while r.get("status") == "ok" and r["data"].get("status") in ("registered", "work_in_progress"):
            time.sleep(poll)
            t = time.perf_counter()
            r = post(self.base, body)
            self.polls += 1
            self.poll_s += time.perf_counter() - t
        if r.get("status") != "ok" or r["data"].get("status") != "success":
            raise RuntimeError(f"block {blk}: the request ended as {r}")
        return r["data"]["proof"]

    def window_start(self) -> None:
        self.kernels.LAUNCHES.reset()
        self.native.CALLS.reset()
        self.prep0 = histogram_totals(self.metrics.PREPARE_INPUT_TIME)
        self.guest0 = histogram_totals(self.metrics.GUEST_PROOF_TIME)
        self.polls, self.poll_s = 0, 0.0

    def window_end(self) -> None:
        c = self.meter.counters
        c["launches"] = sum(self.kernels.LAUNCHES.snapshot().values())
        c["host_keccak_calls"] = sum(self.native.CALLS.snapshot().values())
        prep, guest = histogram_totals(self.metrics.PREPARE_INPUT_TIME), histogram_totals(self.metrics.GUEST_PROOF_TIME)
        c["preflight_s"], c["preflight_n"] = prep[0] - self.prep0[0], prep[1] - self.prep0[1]
        c["guest_s"], c["guest_n"] = guest[0] - self.guest0[0], guest[1] - self.guest0[1]
        c["polls"], c["poll_s"] = self.polls, self.poll_s

    def run(self, i: int) -> None:
        blk = i % self.traffic["blocks"] + 1
        prover, graffiti = self.names(i)
        answer = self.ask(blk, *(self.names(i - 1) if self.inject == "control" and i else (prover, graffiti)))
        if self.inject == "stale" and self.last is not None:
            answer, self.last = self.last, answer
        else:
            self.last = answer
        if self.inject == "altered":
            kzg = bytearray.fromhex(answer["kzg_proof"][2:])
            kzg[-1] ^= 1
            answer = {**answer, "kzg_proof": "0x" + kzg.hex()}
        self.served.append((blk, prover, graffiti, answer))

    def close(self) -> None:
        import torch

        server, self.server = getattr(self, "server", None), None
        if server is not None:
            server.__exit__(None, None, None)
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def block_data(self, blk: int) -> dict:
        """What the chain posted for block `blk`: its blob, its BlockProposed
        event's data and its L2 header's hashes."""
        from raiko_tpu_torch.core import l1_data

        header = self.l2.headers[blk]
        event = None
        for logs in self.l1.block_logs.values():
            for log in logs:
                topics = [bytes.fromhex(t[2:]) for t in log["topics"]]
                if topics and topics[0] == l1_data.BLOCK_PROPOSED_TOPIC0 and int.from_bytes(topics[1], "big") == blk:
                    event = bytes.fromhex(log["data"][2:])
        import native_reference as ref

        vh, blob = ref.blob_hash(event), None
        for sidecars in self.l1.blob_sidecars.values():
            for sc in sidecars:
                commitment = bytes.fromhex(sc["kzg_commitment"][2:])
                h = bytearray(hashlib.sha256(commitment).digest())
                h[0] = 0x01
                if bytes(h) == vh:
                    blob = bytes.fromhex(sc["blob"][2:])
        return {"event": event, "blob": blob, "versioned_hash": vh, "parent_hash": bytes(header.parent_hash),
                "block_hash": header.hash(), "state_root": bytes(header.state_root)}

    def check(self) -> dict:
        import native_reference as ref

        setup = ref.load_setup()
        data = {blk: self.block_data(blk) for blk in sorted({b for b, *_ in self.served})}
        poe_of = {}
        for blk, d in data.items():
            poe_of[blk] = ((0, 0) if self.settings["blob_proof_type"] == "proof_of_commitment"
                           else ref.proof_of_equivalence(d["blob"], d["versioned_hash"], setup))
        wrong_input = 0
        for blk, prover, graffiti, answer in self.served:
            d = data[blk]
            want = ref.instance_hash(self.settings["chain_id"], bytes(20), d["parent_hash"], d["block_hash"],
                                     d["state_root"], bytes.fromhex(graffiti[2:]), bytes.fromhex(prover[2:]),
                                     d["event"], poe_of[blk])
            wrong_input += answer.get("input") != "0x" + want.hex()
        rng = random.Random(self.seed ^ 0xB10B)
        blocks = sorted(data)
        picked = sorted(rng.sample(blocks, min(self.traffic["check_blocks"], len(blocks))))
        wrong_kzg = 0
        for blk in picked:
            want = "0x" + ref.kzg_proof(data[blk]["blob"], data[blk]["versioned_hash"], setup).hex()
            wrong_kzg += sum(a.get("kzg_proof") != want for b, _, _, a in self.served if b == blk)
        return {
            "inputs_differing": {"value": wrong_input, "limit": 0},
            "kzg_proofs_differing": {"value": wrong_kzg, "limit": 0},
            "no_requests": {"value": int(not self.served), "limit": 0},
            "setup_off_published": {"value": ref.setup_faults(setup), "limit": 0},
        }
