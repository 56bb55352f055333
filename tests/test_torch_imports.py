"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` run
on a machine without JAX, so they import neither ``jax``/``jaxlib`` nor
the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_unavailable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.convert, repro_torch.obs, repro_torch.serving\n"
        "import repro_torch.serving.api, repro_torch.models.quantized\n"
        "import repro_torch.configs.base, repro_torch.models.transformer\n"
        "import repro_torch.models.rwkv, repro_torch.models.attention\n"
        "import repro_torch.serving.engine, repro_torch.launch.llm_generate\n"
        "import repro_torch.kernels.decode_attention, repro_torch.kernels.rwkv6\n"
        "import repro_torch.data.synthetic_nemsis, repro_torch.launch.train\n"
        "import repro_torch.training.emsnet_trainer\n"
        "import repro_torch.training.checkpoint\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
