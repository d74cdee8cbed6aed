"""No run loads JAX or the JAX package: the harness's sources import
neither, the refusal compares whole top-level names, and a run on the
CPU ends with neither in sys.modules."""

import ast
import json
import os
import subprocess
import sys
import types

import run

REFUSED = {"jax", "jaxlib", "flax", "raiko_tpu"}


def test_sources_import_no_refused_module():
    for root, dirs, files in os.walk(run.HERE):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build", "_cache")]
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                    names = [node.module]
                assert not {n.split(".")[0] for n in names} & REFUSED, (f, names)


def test_refusal_compares_whole_top_level_names(monkeypatch):
    for name in ("raiko_tpu_torch_like", "jaxon", "raiko_tpu_torch.stark"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.refused_modules() == []
    monkeypatch.setitem(sys.modules, "raiko_tpu.fields", types.ModuleType("raiko_tpu.fields"))
    monkeypatch.setitem(sys.modules, "jax", None)  # a blocked import is not a loaded module
    assert run.refused_modules() == ["raiko_tpu.fields"]


def test_a_cpu_run_loads_neither():
    code = ("import sys, json; sys.path[:0] = [%r, %r]; import run; "
            "rc = run.main(['--workload', 'a7-stark.evm-trees', '--seed', '5', '--seconds', '1'], device='cpu', units=1); "
            "print(json.dumps({'rc': rc, 'refused': run.refused_modules(), "
            "'port': 'raiko_tpu_torch' in sys.modules, 'frozen': 'frozen_verifier' in sys.modules}))"
            % (run.ROOT, run.HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900,
                         env={**os.environ, "PYTHONHASHSEED": "0"})
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"rc": 0, "refused": [], "port": True, "frozen": True}, out.stderr[-3000:]
