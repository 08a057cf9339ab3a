"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``raft_tpu_torch`` is the program,
``raft_tpu`` is not), and the references import nothing of the program."""
import ast
import subprocess
import sys
import textwrap

from perfbench import harness

PKG = harness.ROOT / "perfbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_of_the_harness_names_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.BANNED), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "typing", "torch", "numpy", "math"}, (path, tops)


def test_a_run_loads_no_jax_module():
    code = textwrap.dedent("""
        import sys
        from perfbench.tests import tiny
        from perfbench import harness
        import json
        for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]:
            out = tiny.run(w["name"], seconds=0.2)
            assert out["correct"], out["check"]
        bad = harness.banned_modules()
        assert not bad, bad
        assert "raft_tpu_torch" in sys.modules
        print("clean")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]


def test_banned_names_are_compared_whole():
    sys.modules.setdefault("raft_tpu_torch_lookalike_for_test", sys)
    try:
        assert "raft_tpu_torch_lookalike_for_test" not in harness.banned_modules()
    finally:
        del sys.modules["raft_tpu_torch_lookalike_for_test"]
