"""Chain specs: hard forks, EIP-1559 constants, contract addresses.

Mirrors reference lib/src/consts.rs: a default embedded spec list
(chain/data/chain_spec_list_default.json, same schema as the reference's
host/config/chain_spec_list_default.json) with merge-from-file override
(ref :55-69), fork activation by block or timestamp (ForkCondition
:88-107), and per-verifier addresses."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from enum import IntEnum


class SpecId(IntEnum):
    FRONTIER = 0
    HOMESTEAD = 1
    BYZANTIUM = 2
    ISTANBUL = 3
    LONDON = 4
    MERGE = 5
    SHANGHAI = 6
    CANCUN = 7


@dataclass
class ForkCondition:
    block: int | None = None
    timestamp: int | None = None
    tbd: bool = False

    def active(self, block_no: int, ts: int) -> bool:
        if self.tbd:
            return False
        if self.block is not None:
            return block_no >= self.block
        if self.timestamp is not None:
            return ts >= self.timestamp
        return False

    @classmethod
    def parse(cls, v):
        if v == "TBD":
            return cls(tbd=True)
        if isinstance(v, dict):
            if "Block" in v:
                return cls(block=v["Block"])
            if "Timestamp" in v:
                return cls(timestamp=v["Timestamp"])
        raise ValueError(f"bad fork condition {v}")


@dataclass
class Eip1559Constants:
    base_fee_change_denominator: int = 8
    base_fee_max_increase_denominator: int = 8
    base_fee_max_decrease_denominator: int = 8
    elasticity_multiplier: int = 2


@dataclass
class ChainSpec:
    name: str
    chain_id: int
    max_spec_id: str
    hard_forks: dict  # SpecId name -> ForkCondition
    eip_1559_constants: Eip1559Constants
    l1_contract: str | None = None
    l2_contract: str | None = None
    rpc: str = ""
    beacon_rpc: str | None = None
    verifier_address: dict = field(default_factory=dict)
    genesis_time: int = 0
    seconds_per_slot: int = 12
    is_taiko: bool = False

    def active_fork(self, block_no: int, ts: int) -> SpecId:
        """Highest active fork at (block, timestamp), capped by max_spec_id
        (ref consts.rs:190-214)."""
        best = SpecId.FRONTIER
        for name, cond in self.hard_forks.items():
            sid = SpecId[name]
            if cond.active(block_no, ts) and sid > best:
                best = sid
        cap = SpecId[self.max_spec_id]
        if best > cap:
            raise ValueError(
                f"fork {best.name} exceeds max spec {cap.name} for {self.name}"
            )
        return best

    @classmethod
    def from_json(cls, d: dict) -> "ChainSpec":
        e = d.get("eip_1559_constants", {})

        def hx(v, default):
            if v is None:
                return default
            return int(v, 16) if isinstance(v, str) else int(v)

        return cls(
            name=d["name"],
            chain_id=d["chain_id"],
            max_spec_id=d["max_spec_id"],
            hard_forks={
                k: ForkCondition.parse(v) for k, v in d["hard_forks"].items()
            },
            eip_1559_constants=Eip1559Constants(
                hx(e.get("base_fee_change_denominator"), 8),
                hx(e.get("base_fee_max_increase_denominator"), 8),
                hx(e.get("base_fee_max_decrease_denominator"), 8),
                hx(e.get("elasticity_multiplier"), 2),
            ),
            l1_contract=d.get("l1_contract"),
            l2_contract=d.get("l2_contract"),
            rpc=d.get("rpc", ""),
            beacon_rpc=d.get("beacon_rpc"),
            verifier_address=d.get("verifier_address", {}),
            genesis_time=d.get("genesis_time", 0),
            seconds_per_slot=d.get("seconds_per_slot", 12),
            is_taiko=d.get("is_taiko", False),
        )


_DEFAULT_PATH = os.path.join(
    os.path.dirname(__file__), "data", "chain_spec_list_default.json"
)


class SupportedChainSpecs:
    def __init__(self, path: str | None = None):
        with open(_DEFAULT_PATH) as f:
            specs = [ChainSpec.from_json(d) for d in json.load(f)]
        self._by_name = {s.name: s for s in specs}
        if path:
            self.merge_from_file(path)

    def merge_from_file(self, path: str) -> None:
        """Later entries win by name (ref consts.rs:55-69)."""
        with open(path) as f:
            for d in json.load(f):
                spec = ChainSpec.from_json(d)
                self._by_name[spec.name] = spec

    def get(self, name: str) -> ChainSpec:
        try:
            return self._by_name[name]
        except KeyError:
            # reference RaikoError::InvalidRequestConfig("unsupported
            # network") — surfaces as a JSON error, not a raw 500
            from ..core.interfaces import InvalidRequestConfig

            raise InvalidRequestConfig(
                f"unsupported network: {name!r} (supported: "
                f"{', '.join(self._by_name)})"
            ) from None

    def get_chain_spec_with_chain_id(self, chain_id: int) -> ChainSpec | None:
        for s in self._by_name.values():
            if s.chain_id == chain_id:
                return s
        return None

    def supported_networks(self) -> list[str]:
        return list(self._by_name)
