"""Block data providers (reference core/src/provider/).

``BlockDataProvider`` is the data-access trait preflight runs against
(ref provider/mod.rs:17-31).  Two implementations:

- ``RpcBlockDataProvider``: batched JSON-RPC over httpx, mirroring the
  reference's batch sizes (blocks 32, accounts 250, storage 1000, proofs
  keyed by total slot count 1000; rpc.rs:42-320).
- ``SimBlockDataProvider``: wraps the in-memory chain simulator so the full
  preflight/orchestrator path is testable offline (the reference has no
  such thing — its integration tests need live RPCs, SURVEY.md §4).
"""

from __future__ import annotations

from ..proto.types import BlockHeader, Transaction, Withdrawal
from .interfaces import RpcError


class BlockDataProvider:
    def get_blocks(self, numbers: list[int]) -> list[tuple]:
        """-> [(header, txs, withdrawals)]"""
        raise NotImplementedError

    def get_accounts(self, block: int, addresses: list[bytes]) -> list[dict]:
        """-> [{nonce, balance, code}]"""
        raise NotImplementedError

    def get_storage_values(self, block: int, keys: list[tuple[bytes, int]]) -> list[int]:
        raise NotImplementedError

    def get_merkle_proofs(
        self, block: int, accounts: dict[bytes, list[int]]
    ) -> dict[bytes, dict]:
        """-> {addr: EIP-1186 proof dict}"""
        raise NotImplementedError

    def get_logs(self, address: bytes, topic0: bytes, block: int) -> list[dict]:
        raise NotImplementedError

    def get_logs_by_block_hash(
        self, address: bytes, topic0: bytes, block_hash: bytes
    ) -> list[dict]:
        """Wire-shaped log dicts ({topics, data, transactionHash}) for the
        contract + signature filter at one block (ref preflight.rs:431-440
        Filter::new().address().at_block_hash().event_signature())."""
        raise NotImplementedError

    def get_transaction_by_hash(self, tx_hash: bytes):
        """-> Transaction | None (ref preflight.rs:455-459)."""
        raise NotImplementedError

    def call_contract(self, to: bytes, data: bytes) -> bytes:
        """eth_call: the transport for the on-chain registration +
        verifier analogs (provers/onchain.py)."""
        raise NotImplementedError


def get_task_data(network: str, block_number: int, chain_specs) -> tuple[int, bytes]:
    """(chain_id, blockhash) task key (reference provider/mod.rs:33-51)."""
    spec = chain_specs.get(network)
    provider = provider_for(spec)
    header, _, _ = provider.get_blocks([block_number])[0]
    return spec.chain_id, header.hash()


_SIM_REGISTRY: dict[str, object] = {}


def register_sim(network: str, sim) -> None:
    """Route a network name to an in-process simulator (tests / dev)."""
    _SIM_REGISTRY[network] = sim


def provider_for(spec) -> BlockDataProvider:
    if spec.name in _SIM_REGISTRY:
        return SimBlockDataProvider(_SIM_REGISTRY[spec.name])
    return RpcBlockDataProvider(spec.rpc)


class SimBlockDataProvider(BlockDataProvider):
    def __init__(self, sim):
        self.sim = sim

    def get_blocks(self, numbers):
        out = []
        for n in numbers:
            h, txs, wd = self.sim.get_block(n)
            out.append((BlockHeader.decode(h.encode()), list(txs), list(wd)))
        return out

    def get_accounts(self, block, addresses):
        out = []
        for a in addresses:
            info = self.sim.get_account(block, a)
            if info is None:
                out.append({"nonce": 0, "balance": 0, "code": b""})
            else:
                out.append(
                    {"nonce": info.nonce, "balance": info.balance, "code": info.code}
                )
        return out

    def get_storage_values(self, block, keys):
        return [self.sim.get_storage(block, a, s) for a, s in keys]

    def get_merkle_proofs(self, block, accounts):
        return {
            addr: self.sim.get_proof(block, addr, slots)
            for addr, slots in accounts.items()
        }

    def get_logs(self, address, topic0, block):
        return self.sim.get_logs(address, topic0, block) if hasattr(self.sim, "get_logs") else []

    def get_logs_by_block_hash(self, address, topic0, block_hash):
        return self.sim.get_logs_by_block_hash(address, topic0, block_hash)

    def get_transaction_by_hash(self, tx_hash):
        return self.sim.get_transaction_by_hash(tx_hash)

    def call_contract(self, to, data):
        return self.sim.eth_call(to, data)


class RpcBlockDataProvider(BlockDataProvider):
    """Batched JSON-RPC provider (reference rpc.rs batching strategy)."""

    BLOCK_BATCH = 32
    ACCOUNT_BATCH = 250
    STORAGE_BATCH = 1000
    PROOF_KEY_BATCH = 1000

    def __init__(self, url: str):
        self.url = url
        self._id = 0

    def _batch(self, calls: list[tuple[str, list]]) -> list:
        import httpx

        payload = []
        for method, params in calls:
            self._id += 1
            payload.append(
                {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
            )
        try:
            resp = httpx.post(self.url, json=payload, timeout=30.0)
            resp.raise_for_status()
        except Exception as e:  # pragma: no cover - network
            raise RpcError(f"rpc batch failed: {e}") from e
        results = {r["id"]: r for r in resp.json()}
        out = []
        for req in payload:
            r = results.get(req["id"])
            if r is None or "error" in r:
                raise RpcError(f"rpc error for {req['method']}: {r}")
            out.append(r["result"])
        return out

    def get_blocks(self, numbers):
        out = []
        for off in range(0, len(numbers), self.BLOCK_BATCH):
            chunk = numbers[off : off + self.BLOCK_BATCH]
            res = self._batch(
                [("eth_getBlockByNumber", [hex(n), True]) for n in chunk]
            )
            out.extend(_parse_block(b) for b in res)
        return out

    def get_accounts(self, block, addresses):
        out = []
        tag = hex(block)
        for off in range(0, len(addresses), self.ACCOUNT_BATCH):
            chunk = addresses[off : off + self.ACCOUNT_BATCH]
            calls = []
            for a in chunk:
                ah = "0x" + a.hex()
                calls += [
                    ("eth_getTransactionCount", [ah, tag]),
                    ("eth_getBalance", [ah, tag]),
                    ("eth_getCode", [ah, tag]),
                ]
            res = self._batch(calls)
            for i in range(len(chunk)):
                out.append(
                    {
                        "nonce": int(res[3 * i], 16),
                        "balance": int(res[3 * i + 1], 16),
                        "code": bytes.fromhex(res[3 * i + 2][2:]),
                    }
                )
        return out

    def get_storage_values(self, block, keys):
        out = []
        tag = hex(block)
        for off in range(0, len(keys), self.STORAGE_BATCH):
            chunk = keys[off : off + self.STORAGE_BATCH]
            res = self._batch(
                [
                    ("eth_getStorageAt", ["0x" + a.hex(), hex(s), tag])
                    for a, s in chunk
                ]
            )
            out.extend(int(v, 16) for v in res)
        return out

    def get_merkle_proofs(self, block, accounts):
        out = {}
        tag = hex(block)
        batch: list[tuple[bytes, list[int]]] = []
        count = 0

        def flush():
            nonlocal batch, count
            if not batch:
                return
            res = self._batch(
                [
                    (
                        "eth_getProof",
                        ["0x" + a.hex(), [hex(s) for s in slots], tag],
                    )
                    for a, slots in batch
                ]
            )
            for (a, slots), r in zip(batch, res):
                out[a] = _parse_proof(r)
            batch, count = [], 0

        for addr, slots in accounts.items():
            batch.append((addr, slots))
            count += max(1, len(slots))
            if count >= self.PROOF_KEY_BATCH:
                flush()
        flush()
        return out

    def get_logs(self, address, topic0, block):
        res = self._batch(
            [
                (
                    "eth_getLogs",
                    [
                        {
                            "address": "0x" + address.hex(),
                            "topics": ["0x" + topic0.hex()],
                            "fromBlock": hex(block),
                            "toBlock": hex(block),
                        }
                    ],
                )
            ]
        )[0]
        return res

    def get_logs_by_block_hash(self, address, topic0, block_hash):
        return self._batch(
            [
                (
                    "eth_getLogs",
                    [
                        {
                            "address": "0x" + address.hex(),
                            "topics": ["0x" + topic0.hex()],
                            "blockHash": "0x" + block_hash.hex(),
                        }
                    ],
                )
            ]
        )[0]

    def get_transaction_by_hash(self, tx_hash):
        res = self._batch(
            [("eth_getTransactionByHash", ["0x" + tx_hash.hex()])]
        )[0]
        return _parse_tx(res) if res else None

    def call_contract(self, to, data):
        res = self._batch(
            [
                (
                    "eth_call",
                    [
                        {"to": "0x" + to.hex(), "data": "0x" + data.hex()},
                        "latest",
                    ],
                )
            ]
        )[0]
        return bytes.fromhex(res[2:]) if res and res != "0x" else b""


def _parse_block(b: dict) -> tuple:
    def hx(k, default=0):
        v = b.get(k)
        return int(v, 16) if v else default

    def by(k, n=0):
        v = b.get(k)
        return bytes.fromhex(v[2:]) if v else (b"\x00" * n)

    header = BlockHeader(
        parent_hash=by("parentHash", 32),
        ommers_hash=by("sha3Uncles", 32),
        beneficiary=by("miner", 20),
        state_root=by("stateRoot", 32),
        transactions_root=by("transactionsRoot", 32),
        receipts_root=by("receiptsRoot", 32),
        logs_bloom=by("logsBloom", 256),
        difficulty=hx("difficulty"),
        number=hx("number"),
        gas_limit=hx("gasLimit"),
        gas_used=hx("gasUsed"),
        timestamp=hx("timestamp"),
        extra_data=by("extraData"),
        mix_hash=by("mixHash", 32),
        nonce=by("nonce", 8),
        base_fee_per_gas=hx("baseFeePerGas") if b.get("baseFeePerGas") else None,
        withdrawals_root=by("withdrawalsRoot", 32) if b.get("withdrawalsRoot") else None,
        blob_gas_used=hx("blobGasUsed") if b.get("blobGasUsed") is not None else None,
        excess_blob_gas=hx("excessBlobGas") if b.get("excessBlobGas") is not None else None,
        parent_beacon_block_root=by("parentBeaconBlockRoot", 32)
        if b.get("parentBeaconBlockRoot")
        else None,
    )
    txs = [_parse_tx(t) for t in b.get("transactions", []) if isinstance(t, dict)]
    withdrawals = [
        Withdrawal(
            int(w["index"], 16),
            int(w["validatorIndex"], 16),
            bytes.fromhex(w["address"][2:]),
            int(w["amount"], 16),
        )
        for w in b.get("withdrawals", []) or []
    ]
    return header, txs, withdrawals


def _parse_tx(t: dict) -> Transaction:
    def hx(k, default=0):
        v = t.get(k)
        return int(v, 16) if v else default

    tx_type = hx("type")
    tx = Transaction(
        tx_type=tx_type,
        chain_id=hx("chainId") if t.get("chainId") else None,
        nonce=hx("nonce"),
        gas_price=hx("gasPrice"),
        max_priority_fee_per_gas=hx("maxPriorityFeePerGas"),
        max_fee_per_gas=hx("maxFeePerGas"),
        gas_limit=hx("gas"),
        to=bytes.fromhex(t["to"][2:]) if t.get("to") else None,
        value=hx("value"),
        data=bytes.fromhex(t.get("input", "0x")[2:]),
        access_list=[
            [bytes.fromhex(e["address"][2:]), [bytes.fromhex(k[2:]) for k in e["storageKeys"]]]
            for e in t.get("accessList", []) or []
        ],
        max_fee_per_blob_gas=hx("maxFeePerBlobGas"),
        blob_versioned_hashes=[
            bytes.fromhex(h[2:]) for h in t.get("blobVersionedHashes", []) or []
        ],
        v=hx("v") if tx_type == 0 else hx("yParity", hx("v")),
        r=hx("r"),
        s=hx("s"),
    )
    return tx


def _parse_proof(r: dict) -> dict:
    return {
        "account_proof": [bytes.fromhex(p[2:]) for p in r["accountProof"]],
        "storage_root": bytes.fromhex(r["storageHash"][2:]),
        "storage_proofs": {
            bytes.fromhex(sp["key"][2:]).rjust(32, b"\x00"): [
                bytes.fromhex(p[2:]) for p in sp["proof"]
            ]
            for sp in r.get("storageProof", [])
        },
        "nonce": int(r["nonce"], 16),
        "balance": int(r["balance"], 16),
        "code_hash": bytes.fromhex(r["codeHash"][2:]),
    }
