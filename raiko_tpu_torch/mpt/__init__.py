"""Sparse Merkle-Patricia trie (reference lib/src/primitives/mpt.rs)."""

from .trie import (  # noqa: F401
    EMPTY_ROOT,
    MptError,
    MptNode,
    add_orphaned_leafs,
    index_trie_root,
    is_not_included,
    keccak_trie_root,
    mpt_from_proof,
    proofs_to_tries,
    resolve_nodes,
    to_nibs,
)
