"""Protocol data model: RLP, Ethereum types, GuestInput, ProtocolInstance,
ABI encoding (reference lib/src/input.rs, protocol_instance.rs)."""
