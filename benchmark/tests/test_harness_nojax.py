"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name; the reference imports nothing of the port;
with no card, or with no program beside it, the command prints no
result."""

import ast
import json
import shutil
import subprocess
import sys

import harness
from conftest import BENCH, ROOT


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_and_the_reference_none_of_the_port():
    for path in BENCH.rglob("*.py"):
        names = set(_top_level_imports(path))
        assert not names & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "ompi_release_tpu_torch" not in names, path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ompi_release_tpu_torch_x", sys)
    assert "ompi_release_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax():
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}]\n"
        "from conftest import TINY\n"
        "import harness\n"
        "w = 'gradsync.bert_large_ddp_8r'\n"
        "r = harness.run(w, 3, 0.1, False, t_start=time.perf_counter(),"
        " device='cpu', overrides=TINY[w])\n"
        "print(json.dumps([r['correct'], sorted({m.split('.')[0]"
        " for m in sys.modules})]))\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=BENCH / "tests", capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    correct, mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct
    assert not set(mods) & set(harness.FORBIDDEN)
    assert "ompi_release_tpu_torch" in mods


def test_without_a_card_or_a_program_there_is_no_result(tmp_path):
    args = ["--workload", "allreduce_mid.nccl_tests_8r", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        res = subprocess.run(
            [sys.executable, "benchmark/run.py"] + args, cwd=cwd,
            capture_output=True, text=True, timeout=300)
        if cwd == ROOT and res.returncode == 0:
            continue  # a card is present: the command runs
        assert res.returncode != 0 and res.stdout == "", res.stdout
