"""The port stands alone: a fresh interpreter imports every module of
``repro_torch``, its launchers among them, and neither JAX nor any module
of the JAX package (``repro``) is loaded afterwards."""

import json
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "foreign": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "repro"))}))
"""


def test_every_port_module_imports_without_jax_or_the_reference():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.splitlines()[-1])
    assert report["foreign"] == []
    for name in ("repro_torch.launch.pool", "repro_torch.launch.service",
                 "repro_torch.launch.cluster", "repro_torch.service.daemon",
                 "repro_torch.cluster.pool", "repro_torch.multitenant.pool",
                 "repro_torch.obs.perfetto", "repro_torch.core.runtime",
                 "repro_torch.core.autotune", "repro_torch.launch.mesh",
                 "repro_torch.sharding", "repro_torch.sharding.specs",
                 "repro_torch.sharding.collective_matmul",
                 "repro_torch.serving.kvcache"):
        assert name in report["imported"]
