"""Milliseconds per request of every ``evm.block_header`` span: each
re-execution of the block (``calculate_block_header``), the output's and
the native prover's."""


def read(run):
    s = run.spans.total_s("evm.block_header")
    return s / run.units * 1e3 if run.units and s else None
