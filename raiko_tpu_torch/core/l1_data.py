"""Live L1 proposal + blob retrieval (reference core/src/preflight.rs:283-466).

The pieces preflight needs to locate a Taiko block's data availability on
L1 without any simulator shortcut:

- anchor-tx calldata decode (``anchor(bytes32 l1Hash, bytes32 l1StateRoot,
  uint64 l1BlockId, uint32 parentGasUsed)`` — the vendored
  reth_evm_ethereum::taiko::decode_anchor the reference calls at
  preflight.rs:203),
- the ``BlockProposed`` event lookup by log filter on the L1 inclusion
  block (preflight.rs:420-466),
- ``proposeBlock(bytes params, bytes txList)`` calldata decode for
  calldata-DA blocks (preflight.rs:264-267),
- beacon-chain blob retrieval by slot with versioned-hash matching, and
  the blobscan fallback (preflight.rs:300-418), with
  ``block_time_to_block_slot`` (preflight.rs:283-299).

Everything here speaks the real wire formats (ABI-encoded logs, hex-blob
beacon JSON); tests drive it over actual HTTP facades
(tests/test_rpc_wire.py) as well as through the in-process simulator,
which serves the same shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..proto import abi
from ..proto.instance import BLOCK_METADATA_SPEC, ETH_DEPOSIT_SPEC, BlockMetadata
from ..utils import keccak256
from .interfaces import PreflightError

# -- ABI constants -----------------------------------------------------------

ANCHOR_SELECTOR = keccak256(b"anchor(bytes32,bytes32,uint64,uint32)")[:4]
PROPOSE_BLOCK_SELECTOR = keccak256(b"proposeBlock(bytes,bytes)")[:4]

# event BlockProposed(uint256 indexed blockId, address indexed
#   assignedProver, uint96 livenessBond, BlockMetadata meta,
#   EthDeposit[] depositsProcessed)   (reference input.rs:180-186)
BLOCK_PROPOSED_TOPIC0 = keccak256(
    b"BlockProposed(uint256,address,uint96,"
    b"(bytes32,bytes32,bytes32,bytes32,bytes32,address,uint64,uint32,"
    b"uint64,uint64,uint16,bool,bytes32,address),"
    b"(address,uint96,uint64)[])"
)

_EVENT_DATA_SPECS = [
    "uint96",
    BLOCK_METADATA_SPEC,
    ("array", ETH_DEPOSIT_SPEC),
]


@dataclass
class AnchorCall:
    l1_hash: bytes
    l1_state_root: bytes
    l1_block_id: int
    parent_gas_used: int


def encode_anchor(call: AnchorCall) -> bytes:
    return ANCHOR_SELECTOR + abi.encode(
        ["bytes32", "bytes32", "uint64", "uint32"],
        [call.l1_hash, call.l1_state_root, call.l1_block_id, call.parent_gas_used],
    )


def decode_anchor(data: bytes) -> AnchorCall:
    if data[:4] != ANCHOR_SELECTOR:
        raise PreflightError("anchor tx calldata has wrong selector")
    vals = abi.decode(["bytes32", "bytes32", "uint64", "uint32"], data[4:])
    return AnchorCall(*vals)


def encode_propose_block(params: bytes, tx_list: bytes) -> bytes:
    return PROPOSE_BLOCK_SELECTOR + abi.encode(
        ["bytes", "bytes"], [params, tx_list]
    )


def decode_propose_block(data: bytes) -> tuple[bytes, bytes]:
    if data[:4] != PROPOSE_BLOCK_SELECTOR:
        raise PreflightError("could not decode proposeBlock calldata")
    params, tx_list = abi.decode(["bytes", "bytes"], data[4:])
    return params, tx_list


def encode_block_proposed_event(
    block_id: int,
    assigned_prover: bytes,
    liveness_bond: int,
    meta: BlockMetadata,
    deposits: list | None = None,
) -> tuple[list[bytes], bytes]:
    """(topics, data) exactly as an EVM log would carry them."""
    topics = [
        BLOCK_PROPOSED_TOPIC0,
        int(block_id).to_bytes(32, "big"),
        bytes(assigned_prover).rjust(32, b"\x00"),
    ]
    data = abi.encode(
        _EVENT_DATA_SPECS, [liveness_bond, meta.values(), deposits or []]
    )
    return topics, data


def decode_block_proposed_event(topics: list[bytes], data: bytes):
    """-> (block_id, BlockMetadata) from a raw log."""
    if not topics or bytes(topics[0]) != BLOCK_PROPOSED_TOPIC0:
        raise PreflightError("log is not a BlockProposed event")
    if len(topics) < 3:
        raise PreflightError("BlockProposed log has too few topics")
    block_id = int.from_bytes(bytes(topics[1]), "big")
    try:
        _bond, meta_vals, _deposits = abi.decode(_EVENT_DATA_SPECS, data)
    except Exception as e:
        raise PreflightError(f"malformed BlockProposed log data: {e}") from e
    field_names = [
        "l1_hash",
        "difficulty",
        "blob_hash",
        "extra_data",
        "deposits_hash",
        "coinbase",
        "block_id",
        "gas_limit",
        "timestamp",
        "l1_height",
        "min_tier",
        "blob_used",
        "parent_meta_hash",
        "sender",
    ]
    meta = BlockMetadata(**dict(zip(field_names, meta_vals)))
    return block_id, meta


# -- proposal event lookup ---------------------------------------------------


def get_block_proposed_event(
    l1_provider, taiko_spec, l1_inclusion_block_hash: bytes, l2_block_number: int
):
    """Find the BlockProposed event for ``l2_block_number`` in the L1
    inclusion block and fetch the proposing transaction
    (ref preflight.rs:420-466: filter by contract address + signature
    topic at the block hash; several blocks can be proposed per L1 block,
    so match on the indexed blockId).

    -> (proposal_tx, BlockMetadata)
    """
    if not taiko_spec.l1_contract:
        raise PreflightError("no L1 contract address in the chain spec")
    l1_address = bytes.fromhex(taiko_spec.l1_contract[2:].zfill(40))
    logs = l1_provider.get_logs_by_block_hash(
        l1_address, BLOCK_PROPOSED_TOPIC0, l1_inclusion_block_hash
    )
    for log in logs:
        # guard the wire shapes: a malformed/truncated log from an RPC must
        # surface as PreflightError, not IndexError/ValueError
        try:
            topics = [_b32(t) for t in log["topics"]]
            data = _by(log["data"])
        except Exception as e:
            raise PreflightError(f"malformed log from L1 RPC: {e}") from e
        block_id, meta = decode_block_proposed_event(topics, data)
        if block_id != l2_block_number:
            continue
        try:
            tx_hash = _b32(log["transactionHash"])
        except Exception as e:
            raise PreflightError(f"malformed log from L1 RPC: {e}") from e
        tx = l1_provider.get_transaction_by_hash(tx_hash)
        if tx is None:
            raise PreflightError("could not find the propose tx")
        return tx, meta
    raise PreflightError(
        f"no BlockProposed event found for block {l2_block_number}"
    )


def _b32(v) -> bytes:
    return bytes.fromhex(v[2:]) if isinstance(v, str) else bytes(v)


def _by(v) -> bytes:
    return bytes.fromhex(v[2:]) if isinstance(v, str) else bytes(v)


# -- beacon / blobscan blob retrieval ---------------------------------------


def block_time_to_block_slot(
    block_time: int, genesis_time: int, seconds_per_slot: int
) -> int:
    """ref preflight.rs:283-299."""
    if genesis_time == 0:
        raise PreflightError("genesis time is 0, please check chain spec")
    if block_time < genesis_time:
        raise PreflightError("provided block_time precedes genesis time")
    return (block_time - genesis_time) // seconds_per_slot


def calc_blob_versioned_hash(blob_hex: str, device) -> bytes:
    """Commit the raw blob and hash — used to pick the right sidecar
    (ref preflight.rs:304-315).  The commitment's MSM runs on `device`
    (None: the host)."""
    from ..kzg import eip4844

    blob = _blob_to_bytes(blob_hex)
    commitment = eip4844.blob_to_kzg_commitment(blob, device)
    return eip4844.commitment_to_version_hash(commitment)


def _blob_to_bytes(blob_str: str) -> bytes:
    s = blob_str.lower()
    if s.startswith("0x"):
        s = s[2:]
    return bytes.fromhex(s)


def get_blob_data(l1_spec, slot: int, blob_hash: bytes, device) -> bytes:
    """Blob bytes for ``blob_hash`` at ``slot`` — beacon
    ``/eth/v1/beacon/blob_sidecars/{slot}`` by default, blobscan
    ``/blobs/{hash}`` when the configured URL is a blobscan endpoint
    (ref preflight.rs:317-417).  The in-process chain simulator can stand
    in for the beacon node by registering itself (core.provider
    register_sim) with a ``get_blob_sidecars(slot)`` method returning the
    same sidecar JSON shape."""
    from .provider import _SIM_REGISTRY

    sim = _SIM_REGISTRY.get(l1_spec.name)
    if sim is not None and hasattr(sim, "get_blob_sidecars"):
        sidecars = sim.get_blob_sidecars(slot)
        return _match_sidecar(sidecars, blob_hash, device)

    beacon_url = l1_spec.beacon_rpc
    if not beacon_url:
        raise PreflightError("beacon RPC URL is required for Taiko chains")
    if "blobscan" in beacon_url:
        return _get_blob_blobscan(beacon_url, blob_hash, device)
    return _get_blob_beacon(beacon_url, slot, blob_hash, device)


def _match_sidecar(sidecars: list[dict], blob_hash: bytes, device) -> bytes:
    if not sidecars:
        raise PreflightError("blob data not available anymore")
    for sc in sidecars:
        if calc_blob_versioned_hash(sc["blob"], device) == blob_hash:
            return _blob_to_bytes(sc["blob"])
    raise PreflightError("no sidecar matches the blob versioned hash")


def _get_blob_beacon(beacon_url: str, slot: int, blob_hash: bytes, device) -> bytes:
    import httpx

    url = f"{beacon_url.rstrip('/')}/eth/v1/beacon/blob_sidecars/{slot}"
    try:
        resp = httpx.get(url, timeout=30.0)
        resp.raise_for_status()
    except Exception as e:
        raise PreflightError(f"beacon blob request failed: {e}") from e
    return _match_sidecar(resp.json().get("data", []), blob_hash, device)


def _get_blob_blobscan(base_url: str, blob_hash: bytes, device) -> bytes:
    import httpx

    url = f"{base_url.rstrip('/')}/blobs/0x{blob_hash.hex()}"
    try:
        resp = httpx.get(url, timeout=30.0)
        resp.raise_for_status()
    except Exception as e:
        raise PreflightError(f"blobscan blob request failed: {e}") from e
    blob_hex = resp.json()["data"]
    # uniform contract with the beacon path: verify the returned blob
    # actually matches the requested versioned hash (the reference trusts
    # blobscan here and relies on the later recommit; we don't)
    if calc_blob_versioned_hash(blob_hex, device) != blob_hash:
        raise PreflightError("blobscan blob does not match the versioned hash")
    return _blob_to_bytes(blob_hex)
