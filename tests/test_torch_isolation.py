"""The port and chip_smoke.py import neither jax nor anything of the JAX
package `embedding_cpp_tpu` nor its benchmark scripts (`benchmarks/`):
checked in a fresh interpreter and by a scan of every import statement in
their sources.  No port source names `native/build` (the Makefile's
output) or a `TPUEMBED_*_LIB` library path: the port builds its own host
libraries."""
import ast
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "embedding_cpp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "embedding_cpp_tpu", "benchmarks")

_PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {repo!r})
import embedding_cpp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "embedding_cpp_tpu", "benchmarks"))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def test_importing_everything_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert "embedding_cpp_tpu_torch.runtime.server" in result["modules"]
    assert "embedding_cpp_tpu_torch.ops.q4_matmul" in result["modules"]
    for name in ("models.modernbert", "models.nomic", "models.bert", "models.t5",
                 "models.deberta", "runtime.engine", "tokenizer.bpe", "ops.attention",
                 "utils.metrics", "utils.profiling", "benchmarks.kernels",
                 "benchmarks.profiles", "tokenizer.native", "tokenizer.hf",
                 "gguf.native_codec", "utils.jsonfmt", "utils.logging", "utils.native_build",
                 "utils.shared_libs", "runtime.http_server", "runtime.client", "cli.main",
                 "cli.rerank", "cli.engine_io", "parallel", "parallel.mesh",
                 "parallel.group", "parallel.sharding", "parallel.distributed",
                 "benchmarks.tasks", "benchmarks.run_eval", "benchmarks.print_tables",
                 "benchmarks.bench", "benchmarks.serving", "benchmarks.scaling",
                 "benchmarks.search", "benchmarks.sparse", "benchmarks.maxsim_bench",
                 "benchmarks.indexes", "examples", "examples.semantic_search",
                 "examples.sparse_retrieval", "examples.late_interaction_search",
                 "examples.sample_client"):
        assert f"embedding_cpp_tpu_torch.{name}" in result["modules"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    assert {f.name for f in files if f.parent.name == "parallel"} >= {
        "mesh.py", "group.py", "sharding.py", "distributed.py"}
    assert {f.name for f in files if f.parent.name == "benchmarks"} >= {
        "tasks.py", "run_eval.py", "print_tables.py", "bench.py", "serving.py", "scaling.py",
        "search.py", "sparse.py", "maxsim_bench.py"}
    assert {f.name for f in files if f.parent.name == "examples"} >= {
        "semantic_search.py", "sparse_retrieval.py", "late_interaction_search.py",
        "sample_client.py"}
    offenders = {str(f.relative_to(REPO)): sorted(_imported_roots(f) & set(FORBIDDEN))
                 for f in files}
    assert {f: r for f, r in offenders.items() if r} == {}


def _native_build_refs(path: Path) -> list[str]:
    """String constants naming the Makefile's output or a library path
    variable, and `... / "native" / "build"` path joins."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            found += [w for w in ("native/build", "TPUEMBED_TOKENIZER_LIB", "TPUEMBED_CODEC_LIB",
                                  "TPUEMBED_JSONFMT_LIB", "libtpuembed_capi")
                      if w in node.value]
        elif (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)
              and isinstance(node.right, ast.Constant) and node.right.value == "build"
              and isinstance(node.left, ast.BinOp)
              and isinstance(node.left.right, ast.Constant)
              and node.left.right.value == "native"):
            found.append('"native" / "build"')
    return found


def test_sources_load_no_library_from_native_build():
    """The port compiles `native/`'s sources into its own `_build/`: no
    source of it, nor chip_smoke.py, reads the Makefile's output directory
    or reads the JAX package's library variables."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = {str(f.relative_to(REPO)): _native_build_refs(f) for f in files}
    assert {f: r for f, r in offenders.items() if r} == {}
    assert _native_build_refs(REPO / "embedding_cpp_tpu" / "tokenizer" / "native.py")
