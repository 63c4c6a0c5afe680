"""No module of the benchmark pulls in JAX or the JAX package, and the
reference pulls in nothing of the port either: each checked in a fresh
interpreter, top-level module names compared whole."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from _cells import ROOT

_PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
names = {names!r}
for name in names:
    importlib.import_module(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(sub: str) -> list[str]:
    pkg = ROOT / "perfbench" / sub if sub else ROOT / "perfbench"
    base = "perfbench" + (f".{sub}" if sub else "")
    out = [base]
    for p in sorted(pkg.glob("*.py")):
        if p.stem != "__init__" and "." not in p.stem:
            out.append(f"{base}.{p.stem}")
    return out


def _loaded(names: list[str]) -> set[str]:
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT), names=names)],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_loads_no_jax():
    names = (_modules("") + _modules("traffic") + _modules("reference")
             + _modules("layer_metrics"))
    assert "perfbench.harness" in names and "perfbench.traffic.bulk_encode" in names
    roots = _loaded(names)
    assert not roots & {"jax", "jaxlib", "flax", "embedding_cpp_tpu", "benchmarks"}


def test_metric_readers_load_no_jax():
    probe = ("import importlib.util, json, sys, pathlib\n"
             f"sys.path.insert(0, {str(ROOT)!r})\n"
             f"for p in sorted(pathlib.Path({str(ROOT / 'perfbench' / 'layer_metrics')!r})"
             ".glob('*.py')):\n"
             "    s = importlib.util.spec_from_file_location('m_' + p.stem.replace('.', '_'), p)\n"
             "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & {
        "jax", "jaxlib", "flax", "embedding_cpp_tpu"}


@pytest.mark.parametrize("arch", ["bert", "modernbert"])
def test_reference_loads_nothing_of_the_port(arch):
    names = ["perfbench.reference", f"perfbench.reference.{arch}", "perfbench.reference.common",
             "perfbench.weights", "perfbench.vocab", "perfbench.check"]
    roots = _loaded(names)
    assert not roots & {"jax", "jaxlib", "flax", "embedding_cpp_tpu",
                        "embedding_cpp_tpu_torch"}
