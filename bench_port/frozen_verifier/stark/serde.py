"""StarkProof <-> JSON-able dict serialization."""

from __future__ import annotations

from . import fri
from .prover import StarkProof


def proof_to_dict(p: StarkProof) -> dict:
    return {
        "log_n": p.log_n,
        "width": p.width,
        "pow_nonce": p.pow_nonce,
        "publics": [int(v) for v in p.publics],
        "trace_root": [int(v) for v in p.trace_root],
        "quotient_root": [int(v) for v in p.quotient_root],
        "trace_at_zeta": [[int(v) for v in t] for t in p.trace_at_zeta],
        "trace_at_zeta_g": [[int(v) for v in t] for t in p.trace_at_zeta_g],
        "quotient_at_zeta": [[int(v) for v in t] for t in p.quotient_at_zeta],
        "fri": {
            "layer_roots": [[int(v) for v in r] for r in p.fri_proof.layer_roots],
            "final_values": [[int(v) for v in t] for t in p.fri_proof.final_values],
            "query_proofs": [
                [
                    {
                        "pair": [[int(v) for v in e] for e in layer["pair"]],
                        "path": [[int(v) for v in d] for d in layer["path"]],
                    }
                    for layer in q
                ]
                for q in p.fri_proof.query_proofs
            ],
        },
        "queries": [
            {
                "trace_row": [int(v) for v in q["trace_row"]],
                "trace_path": [[int(v) for v in d] for d in q["trace_path"]],
                "quot_row": [int(v) for v in q["quot_row"]],
                "quot_path": [[int(v) for v in d] for d in q["quot_path"]],
                **(
                    {
                        "aux_row": [int(v) for v in q["aux_row"]],
                        "aux_path": [[int(v) for v in d] for d in q["aux_path"]],
                    }
                    if "aux_row" in q
                    else {}
                ),
                **(
                    {
                        "fixed_row": [int(v) for v in q["fixed_row"]],
                        "fixed_path": [[int(v) for v in d] for d in q["fixed_path"]],
                    }
                    if "fixed_row" in q
                    else {}
                ),
            }
            for q in p.queries
        ],
        "aux_root": [int(v) for v in p.aux_root],
        "aux_at_zeta": [[int(v) for v in t] for t in p.aux_at_zeta],
        "aux_at_zeta_g": [[int(v) for v in t] for t in p.aux_at_zeta_g],
        "bus": [[int(v) for v in t] for t in p.bus],
        "fixed_root": [int(v) for v in p.fixed_root],
        "fixed_at_zeta": [[int(v) for v in t] for t in p.fixed_at_zeta],
    }


def proof_from_dict(d: dict) -> StarkProof:
    return StarkProof(
        log_n=d["log_n"],
        width=d["width"],
        pow_nonce=d.get("pow_nonce", 0),
        publics=list(d["publics"]),
        trace_root=list(d["trace_root"]),
        quotient_root=list(d["quotient_root"]),
        trace_at_zeta=[tuple(t) for t in d["trace_at_zeta"]],
        trace_at_zeta_g=[tuple(t) for t in d["trace_at_zeta_g"]],
        quotient_at_zeta=[tuple(t) for t in d["quotient_at_zeta"]],
        fri_proof=fri.FriProof(
            layer_roots=[list(r) for r in d["fri"]["layer_roots"]],
            final_values=[tuple(t) for t in d["fri"]["final_values"]],
            query_proofs=[
                [
                    {
                        "pair": [tuple(e) for e in layer["pair"]],
                        "path": [list(x) for x in layer["path"]],
                    }
                    for layer in q
                ]
                for q in d["fri"]["query_proofs"]
            ],
        ),
        queries=[
            {
                "trace_row": list(q["trace_row"]),
                "trace_path": [list(x) for x in q["trace_path"]],
                "quot_row": list(q["quot_row"]),
                "quot_path": [list(x) for x in q["quot_path"]],
                **(
                    {
                        "aux_row": list(q["aux_row"]),
                        "aux_path": [list(x) for x in q["aux_path"]],
                    }
                    if "aux_row" in q
                    else {}
                ),
                **(
                    {
                        "fixed_row": list(q["fixed_row"]),
                        "fixed_path": [list(x) for x in q["fixed_path"]],
                    }
                    if "fixed_row" in q
                    else {}
                ),
            }
            for q in d["queries"]
        ],
        aux_root=list(d.get("aux_root", [])),
        aux_at_zeta=[tuple(t) for t in d.get("aux_at_zeta", [])],
        aux_at_zeta_g=[tuple(t) for t in d.get("aux_at_zeta_g", [])],
        bus=[tuple(t) for t in d.get("bus", [])],
        fixed_root=list(d.get("fixed_root", [])),
        fixed_at_zeta=[tuple(t) for t in d.get("fixed_at_zeta", [])],
    )
