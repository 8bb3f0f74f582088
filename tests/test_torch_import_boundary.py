"""The port imports nothing of JAX, of sav_tpu, of TensorFlow or of
ml_dtypes.

Two checks: importing every module of ``sav_tpu_torch`` in a fresh
interpreter (this test process already has jax, via conftest) leaves jax,
flax, sav_tpu, tensorflow and ml_dtypes out of ``sys.modules``; and no
source file of the port, nor ``chip_smoke.py``, has an import statement
naming them.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sav_tpu", "tensorflow", "ml_dtypes"}

_PROBE = """
import importlib, json, pkgutil, sys
import sav_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sav_tpu_torch.__path__, "sav_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def _port_sources():
    return sorted((ROOT / "sav_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "sav_tpu_torch.serve.engine" in report["modules"]
    assert "sav_tpu_torch.ops.fused_attention" in report["modules"]
    assert "sav_tpu_torch.ops.flash_attention" in report["modules"]
    assert "sav_tpu_torch.models.surgery" in report["modules"]
    for name in ("sav_tpu_torch.train.graphs", "sav_tpu_torch.train.bench",
                 "sav_tpu_torch.obs.costs", "sav_tpu_torch.utils.flops",
                 "sav_tpu_torch.utils.graphs", "sav_tpu_torch.data.augment_spec",
                 "sav_tpu_torch.ops.preprocess", "sav_tpu_torch.data.pipeline",
                 "sav_tpu_torch.data.records", "sav_tpu_torch.data.tfrecord",
                 "sav_tpu_torch.data.native_loader", "sav_tpu_torch.obs.alerts",
                 "sav_tpu_torch.obs.rollup", "sav_tpu_torch.obs.memory",
                 "sav_tpu_torch.serve.telemetry", "sav_tpu_torch.serve.quality",
                 "sav_tpu_torch.serve.router", "sav_tpu_torch.serve.fleet",
                 "sav_tpu_torch.serve.serve_fleet", "sav_tpu_torch.obs.quality"):
        assert name in report["modules"]
    leaked = {m for m in report["loaded"] if m.split(".")[0] in FORBIDDEN}
    assert not leaked, f"the port pulled in {sorted(leaked)}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_sav_tpu_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"
