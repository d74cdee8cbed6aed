"""Sparse Merkle-Patricia trie with digest-truncated subtries.

Behavioral parity with reference lib/src/primitives/mpt.rs: a trie node is
Null / Branch / Leaf / Extension / **Digest** (an unresolved subtrie known
only by its keccak reference).  EIP-1186 proofs reconstruct exactly the
slice of the state trie a block touches (``proofs_to_tries``,
ref :1033-1113); get/insert/delete work on the materialized slice and
raise if they would need to traverse a Digest; node references are the
keccak-256 of the RLP encoding, inlined verbatim when shorter than 32
bytes (ref :417-430).

Hashing goes through the host C Keccak (``utils/native.py``), with the
card's batch kernel available for bulk state-root recomputation; node
references are cached and invalidated on mutation (ref's cached_reference).
"""

from __future__ import annotations

from ..proto import rlp
from ..utils import keccak256

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)


class MptError(Exception):
    pass


NULL = "null"
BRANCH = "branch"
LEAF = "leaf"
EXTENSION = "extension"
DIGEST = "digest"


class MptNode:
    __slots__ = ("kind", "children", "value", "nibbles", "digest", "_ref")

    def __init__(self, kind=NULL, children=None, value=b"", nibbles=(), digest=b""):
        self.kind = kind
        self.children = children  # list[16] for branch, [child] for extension
        self.value = value
        self.nibbles = tuple(nibbles)
        self.digest = digest
        self._ref = None

    # -- constructors -----------------------------------------------------
    @classmethod
    def null(cls):
        return cls(NULL)

    @classmethod
    def leaf(cls, nibbles, value):
        return cls(LEAF, value=value, nibbles=nibbles)

    @classmethod
    def extension(cls, nibbles, child):
        assert len(nibbles) > 0
        return cls(EXTENSION, children=[child], nibbles=nibbles)

    @classmethod
    def branch(cls, children=None):
        return cls(BRANCH, children=children or [cls.null() for _ in range(16)])

    @classmethod
    def from_digest(cls, digest: bytes):
        assert len(digest) == 32
        return cls(DIGEST, digest=digest)

    def is_empty(self) -> bool:
        return self.kind == NULL

    def invalidate(self):
        self._ref = None

    # -- encoding / references -------------------------------------------
    def encode(self) -> bytes:
        """RLP encoding of this node (Digest nodes cannot be encoded)."""
        if self.kind == NULL:
            return rlp.encode(b"")
        if self.kind == LEAF:
            return rlp.encode([_encode_path(self.nibbles, True), self.value])
        if self.kind == EXTENSION:
            return rlp.encode(
                [_encode_path(self.nibbles, False), self.children[0].ref_item()]
            )
        if self.kind == BRANCH:
            return rlp.encode([c.ref_item() for c in self.children] + [b""])
        raise MptError("cannot encode digest node")

    def ref_item(self):
        """The node's reference as an RLP-encodable item: inline raw RLP if
        the encoding is < 32 bytes, else the 32-byte keccak digest."""
        if self.kind == NULL:
            return b""
        if self.kind == DIGEST:
            return self.digest
        enc = self.encode()
        if len(enc) < 32:
            return rlp.Raw(enc)
        return self.reference()

    def reference(self) -> bytes:
        """keccak-256 of the encoding (or raw digest for Digest nodes)."""
        if self._ref is None:
            if self.kind == DIGEST:
                self._ref = self.digest
            else:
                self._ref = keccak256(self.encode())
        return self._ref

    def hash(self) -> bytes:
        """Root hash: keccak of the encoding regardless of size (ref
        :386-394 — the root is always hashed)."""
        if self.kind == NULL:
            return EMPTY_ROOT
        if self.kind == DIGEST:
            return self.digest
        return keccak256(self.encode())

    # -- operations -------------------------------------------------------
    def get(self, key_nibbles) -> bytes | None:
        node, rest = self, tuple(key_nibbles)
        while True:
            if node.kind == NULL:
                return None
            if node.kind == DIGEST:
                raise MptError("node not resolved (digest hit during get)")
            if node.kind == LEAF:
                return node.value if node.nibbles == rest else None
            if node.kind == EXTENSION:
                k = node.nibbles
                if rest[: len(k)] != k:
                    return None
                node, rest = node.children[0], rest[len(k) :]
                continue
            # branch
            if not rest:
                return None  # state tries store no branch values
            node, rest = node.children[rest[0]], rest[1:]

    def insert(self, key_nibbles, value: bytes) -> None:
        if not value:
            raise MptError("cannot insert empty value (use delete)")
        self._insert(tuple(key_nibbles), value)

    def _insert(self, key, value) -> None:
        self.invalidate()
        if self.kind == NULL:
            self._become(MptNode.leaf(key, value))
            return
        if self.kind == DIGEST:
            raise MptError("node not resolved (digest hit during insert)")
        if self.kind == LEAF:
            if self.nibbles == key:
                self.value = value
                return
            self._split_and_insert(key, value)
            return
        if self.kind == EXTENSION:
            k = self.nibbles
            common = _common_prefix(k, key)
            if common == len(k):
                self.children[0]._insert(key[len(k) :], value)
                return
            self._split_and_insert(key, value)
            return
        # branch
        if not key:
            raise MptError("branch values not supported (ref :branch-value)")
        self.children[key[0]]._insert(key[1:], value)

    def _split_and_insert(self, key, value) -> None:
        """Split a leaf/extension at the divergence point with `key`."""
        own = self.nibbles
        common = _common_prefix(own, key)
        branch = MptNode.branch()
        # place own remainder
        own_rest = own[common:]
        if self.kind == LEAF:
            if not own_rest:
                raise MptError("branch values not supported")
            branch.children[own_rest[0]] = MptNode.leaf(own_rest[1:], self.value)
        else:  # extension
            child = self.children[0]
            if not own_rest:
                raise MptError("extension fully consumed unexpectedly")
            if len(own_rest) == 1:
                branch.children[own_rest[0]] = child
            else:
                branch.children[own_rest[0]] = MptNode.extension(own_rest[1:], child)
        # place new key
        key_rest = key[common:]
        if not key_rest:
            raise MptError("branch values not supported")
        branch.children[key_rest[0]] = MptNode.leaf(key_rest[1:], value)
        if common:
            self._become(MptNode.extension(own[:common], branch))
        else:
            self._become(branch)

    def delete(self, key_nibbles) -> bool:
        """Delete a key; returns True if something was removed."""
        return self._delete(tuple(key_nibbles))

    def _delete(self, key) -> bool:
        if self.kind == NULL:
            return False
        if self.kind == DIGEST:
            raise MptError("node not resolved (digest hit during delete)")
        if self.kind == LEAF:
            if self.nibbles != key:
                return False
            self.invalidate()
            self._become(MptNode.null())
            return True
        if self.kind == EXTENSION:
            k = self.nibbles
            if key[: len(k)] != k:
                return False
            if not self.children[0]._delete(key[len(k) :]):
                return False
            self.invalidate()
            child = self.children[0]
            # collapse chains
            if child.kind == NULL:
                self._become(MptNode.null())
            elif child.kind == LEAF:
                self._become(MptNode.leaf(k + child.nibbles, child.value))
            elif child.kind == EXTENSION:
                self._become(MptNode.extension(k + child.nibbles, child.children[0]))
            return True
        # branch
        if not key:
            return False
        if not self.children[key[0]]._delete(key[1:]):
            return False
        self.invalidate()
        remaining = [
            (i, c) for i, c in enumerate(self.children) if c.kind != NULL
        ]
        if len(remaining) == 1:
            i, child = remaining[0]
            if child.kind == DIGEST:
                raise MptError(
                    "orphaned digest after delete (need orphan leaf proof)"
                )
            if child.kind == LEAF:
                self._become(MptNode.leaf((i,) + child.nibbles, child.value))
            elif child.kind == EXTENSION:
                self._become(
                    MptNode.extension((i,) + child.nibbles, child.children[0])
                )
            else:  # branch
                self._become(MptNode.extension((i,), child))
        return True

    def clone(self) -> "MptNode":
        """Deep structural copy (finalize mutates tries in place; callers
        that must not consume their input clone first)."""
        if self.kind == BRANCH:
            return MptNode(BRANCH, children=[c.clone() for c in self.children])
        if self.kind == EXTENSION:
            return MptNode(
                EXTENSION, children=[self.children[0].clone()], nibbles=self.nibbles
            )
        if self.kind == LEAF:
            return MptNode(LEAF, value=self.value, nibbles=self.nibbles)
        if self.kind == DIGEST:
            return MptNode(DIGEST, digest=self.digest)
        return MptNode(NULL)

    def proof(self, key_nibbles) -> list[bytes]:
        """EIP-1186-style proof: RLP of every standalone node on the path
        from the root toward ``key`` (inline <32-byte nodes stay embedded in
        their parents; the root is always included)."""
        out: list[bytes] = []
        node, rest = self, tuple(key_nibbles)
        first = True
        while True:
            if node.kind == NULL:
                break
            if node.kind == DIGEST:
                raise MptError("cannot prove through unresolved digest")
            enc = node.encode()
            if first or len(enc) >= 32:
                out.append(enc)
            first = False
            if node.kind == LEAF:
                break
            if node.kind == EXTENSION:
                k = node.nibbles
                if rest[: len(k)] != k:
                    break
                node, rest = node.children[0], rest[len(k) :]
                continue
            if not rest:
                break
            node, rest = node.children[rest[0]], rest[1:]
        return out

    def _become(self, other: "MptNode") -> None:
        self.kind = other.kind
        self.children = other.children
        self.value = other.value
        self.nibbles = other.nibbles
        self.digest = other.digest
        self._ref = None

    def __repr__(self):
        if self.kind == BRANCH:
            kids = "".join(
                format(i, "x") for i, c in enumerate(self.children) if c.kind != NULL
            )
            return f"<branch [{kids}]>"
        if self.kind in (LEAF, EXTENSION):
            return f"<{self.kind} {''.join(format(n,'x') for n in self.nibbles)}>"
        return f"<{self.kind}>"


# -- path encoding ---------------------------------------------------------


def to_nibs(key: bytes) -> tuple:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0xF)
    return tuple(out)


def _encode_path(nibbles, is_leaf: bool) -> bytes:
    flag = 0x20 if is_leaf else 0x00
    if len(nibbles) % 2:
        out = bytearray([flag | 0x10 | nibbles[0]])
        rest = nibbles[1:]
    else:
        out = bytearray([flag])
        rest = nibbles
    for i in range(0, len(rest), 2):
        out.append((rest[i] << 4) | rest[i + 1])
    return bytes(out)


def _decode_path(encoded: bytes) -> tuple[tuple, bool]:
    flag = encoded[0]
    is_leaf = bool(flag & 0x20)
    nibbles = []
    if flag & 0x10:
        nibbles.append(flag & 0xF)
    for b in encoded[1:]:
        nibbles.append(b >> 4)
        nibbles.append(b & 0xF)
    return tuple(nibbles), is_leaf


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


# -- proof reconstruction (ref :919-1113) ----------------------------------


def decode_node(data: bytes) -> MptNode:
    return _node_from_item(rlp.decode(data))


def _node_from_item(item) -> MptNode:
    if isinstance(item, bytes):
        if item == b"":
            return MptNode.null()
        if len(item) == 32:
            return MptNode.from_digest(item)
        raise MptError(f"unexpected byte node of length {len(item)}")
    if len(item) == 2:
        nibbles, is_leaf = _decode_path(item[0])
        if is_leaf:
            return MptNode.leaf(nibbles, item[1])
        return MptNode.extension(nibbles, _node_from_item(item[1]))
    if len(item) == 17:
        if item[16] not in (b"",):
            raise MptError("branch values not supported")
        return MptNode.branch([_node_from_item(c) for c in item[:16]])
    raise MptError(f"unexpected node arity {len(item)}")


def resolve_nodes(root: MptNode, node_store: dict) -> MptNode:
    """Replace digests with nodes from {reference_bytes: MptNode}
    (ref :973-1003).  Unknown digests stay as digests."""
    if root.kind == DIGEST:
        found = node_store.get(root.digest)
        if found is not None:
            return resolve_nodes(found, node_store)
        return root
    if root.kind == EXTENSION:
        return MptNode.extension(
            root.nibbles, resolve_nodes(root.children[0], node_store)
        )
    if root.kind == BRANCH:
        return MptNode.branch(
            [resolve_nodes(c, node_store) for c in root.children]
        )
    return root


def mpt_from_proof(proof_nodes: list[bytes]) -> MptNode:
    """Build a partial trie from an EIP-1186 proof node list (ref :919-961)."""
    if not proof_nodes:
        return MptNode.null()
    store = {}
    decoded = []
    for raw in proof_nodes:
        node = decode_node(raw)
        decoded.append(node)
        store[keccak256(raw)] = node
        if len(raw) < 32:
            # inline-able node: also findable by raw encoding? inline nodes
            # never appear as standalone proof entries in practice
            pass
    return resolve_nodes(MptNode.from_digest(keccak256(proof_nodes[0])), store)


def is_not_included(key: bytes, proof_nodes: list[bytes]) -> bool:
    """Exclusion proof check (ref :964-970)."""
    trie = mpt_from_proof(proof_nodes)
    return trie.get(to_nibs(key)) is None


def shorten_node_path(node: MptNode) -> list[MptNode]:
    """All path-shortened variants of a leaf/extension (ref :1009-1031).

    When keys are deleted, branch collapses EXTEND sibling paths; the
    post-state node's shortened variants therefore include the pre-state
    sibling, findable by reference."""
    out: list[MptNode] = []
    if node.kind == LEAF:
        for i in range(len(node.nibbles) + 1):
            out.append(MptNode.leaf(node.nibbles[i:], node.value))
    elif node.kind == EXTENSION:
        for i in range(1, len(node.nibbles) + 1):
            out.append(MptNode.extension(node.nibbles[i:], node.children[0]))
    return out


def add_orphaned_leafs(key: bytes, proof_nodes: list[bytes], store: dict) -> None:
    """If the FINAL-state proof shows `key` excluded (it was deleted), add
    the shortened variants of the proof's last node to the node store so
    pre-state digests collapse correctly during delete (ref :1116-1133)."""
    if not proof_nodes:
        return
    if is_not_included(keccak256(key), proof_nodes):
        last = decode_node(proof_nodes[-1])
        for variant in shorten_node_path(last):
            store[variant.reference()] = variant


def proofs_to_tries(
    state_root: bytes, accounts: dict, final_accounts: dict | None = None
) -> tuple[MptNode, dict]:
    """Reconstruct the state trie slice + per-account storage tries from
    EIP-1186 proofs (ref :1033-1113).

    accounts: {address_bytes: {"account_proof": [bytes], "storage_root":
    bytes, "storage_proofs": {slot_key_bytes32: [bytes]}}} at the PARENT
    block; final_accounts optionally carries the same shape at the CURRENT
    block so deleted accounts/slots get their orphaned siblings resolved
    (reference proofs_to_tries takes both parent_proofs and proofs).
    Returns (state_trie, {address: storage_trie})."""
    final_accounts = final_accounts or {}
    store: dict[bytes, MptNode] = {}
    storage = {}
    for addr, info in accounts.items():
        for raw in info.get("account_proof", []):
            store[keccak256(raw)] = decode_node(raw)
        fini = final_accounts.get(addr, {})
        add_orphaned_leafs(addr, fini.get("account_proof", []), store)
        st_store: dict[bytes, MptNode] = {}
        for proof in info.get("storage_proofs", {}).values():
            for raw in proof:
                st_store[keccak256(raw)] = decode_node(raw)
        for slot_key, proof in fini.get("storage_proofs", {}).items():
            add_orphaned_leafs(slot_key, proof, st_store)
        sroot = info.get("storage_root", EMPTY_ROOT)
        if sroot == EMPTY_ROOT or not st_store:
            storage[addr] = MptNode.null()
        else:
            storage[addr] = resolve_nodes(MptNode.from_digest(sroot), st_store)
    if state_root == EMPTY_ROOT or not store:
        state = MptNode.null()
    else:
        state = resolve_nodes(MptNode.from_digest(state_root), store)
    return state, storage


def keccak_trie_root(items: list[tuple[bytes, bytes]]) -> bytes:
    """Root of a fresh trie mapping keccak(key) -> value (test helper and
    tx/receipt trie builder)."""
    t = MptNode.null()
    for k, v in items:
        t.insert(to_nibs(k), v)
    return t.hash()


def index_trie_root(items: list[bytes]) -> bytes:
    """Root of a trie keyed by rlp(index) — tx/receipt/withdrawal tries."""
    t = MptNode.null()
    for i, v in enumerate(items):
        t.insert(to_nibs(rlp.encode(i)), v)
    return t.hash()


def hashed_preimages(node: "MptNode") -> list[bytes]:
    """Every RLP node encoding that a state-root recomputation keccaks:
    resolved nodes whose encoding is >= 32 bytes (inline refs are not
    hashed, ref lib/src/primitives/mpt.rs:417-430) plus the root (always
    hashed, :386-394).  Order: depth-first, root first — the message list
    for the batched keccak-sponge STARK (stark/airs/keccak_air.py)."""
    out: list[bytes] = []

    def walk(n: "MptNode", is_root: bool) -> None:
        if n.kind in (NULL, DIGEST):
            return
        enc = n.encode()
        if is_root or len(enc) >= 32:
            out.append(enc)
        if n.children:
            for c in n.children:
                walk(c, False)

    walk(node, True)
    return out
