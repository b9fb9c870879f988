"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the system under test.  Names compare by the
whole top-level name: the port's ``bftkv_tpu_torch`` starts with
``bftkv_tpu``."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

HARNESS = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bftkv_tpu"}


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_harness_imports_no_jax_and_not_the_jax_package():
    bad = {str(p.relative_to(HARNESS)): _imports(p) & FORBIDDEN for p in HARNESS.rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    bad = {}
    for p in [*(HARNESS / "reference").rglob("*.py"), HARNESS / "keys.py"]:
        found = _imports(p) & (FORBIDDEN | {"bftkv_tpu_torch", "torch"})
        if found:
            bad[p.name] = found
    assert not bad


def test_loading_the_harness_loads_no_forbidden_module():
    code = ("import sys\n"
            "import portbench.run, portbench.cluster, portbench.hooks, portbench.layers\n"
            "import portbench.reference.check, portbench.reference.control\n"
            "import bftkv_tpu_torch.protocol.client, bftkv_tpu_torch.protocol.server\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[1:])))\n")
    out = subprocess.run([sys.executable, "-c", code, *sorted(FORBIDDEN)], cwd=HARNESS.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_keys_and_the_reference_load_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.keys, portbench.reference.check, portbench.reference.control\n"
            "import portbench.reference.p256, portbench.reference.sigs, portbench.reference.wire\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[1:])))\n")
    loaded = FORBIDDEN | {"bftkv_tpu_torch", "torch"}
    out = subprocess.run([sys.executable, "-c", code, *sorted(loaded)], cwd=HARNESS.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
