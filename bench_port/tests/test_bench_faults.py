"""Whole runs on the CPU (the look for a card skipped, the port's plain
versions underneath): a sound run is correct, and the control and each
fault the cell can have, planted in the timed path, make ``correct``
false.  The readings on the card at the cells' own sizes come from
``control.py``."""

import pytest

import run

CASES = [
    ("a7-stark.evm-trees", None), ("a7-stark.evm-trees", "control"), ("a7-stark.evm-trees", "stale"),
    ("a7-stark.evm-trees", "half"), ("a7-stark.evm-trees", "altered"),
    ("a7-native.b100", None), ("a7-native.b100", "control"), ("a7-native.b100", "stale"),
    ("a7-native.b100", "altered"),
]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_run_is_correct_only_when_sound(cell, fault, capsys):
    # long enough for two units, so that a stale answer has one to repeat
    rc = run.main(["--workload", cell, "--seed", str(2**33 + 17), "--seconds", "0.01"], inject=fault,
                  device="cpu", units=2)
    assert rc == 0
    result = run.LAST_RESULT
    lines = capsys.readouterr()
    assert lines.out.strip().splitlines()[-1].startswith('{"correct"')
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device", "checked"}
    assert list(result)[-1] == "checked"
    assert result["device"]["platform"] == "cpu" and "memory_peak_bytes" in result["device"]
    assert {"setup_s"} <= set(result["metrics"])
    for name, c in result["checked"].items():
        assert f"checked {name}: {c['value']} (limit {c['limit']})" in lines.err
    assert result["correct"] is (fault is None), result["checked"]
