"""Chain specifications (reference lib/src/consts.rs)."""

from .specs import ChainSpec, SupportedChainSpecs, ForkCondition, SpecId  # noqa: F401
