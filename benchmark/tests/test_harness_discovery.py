"""A configuration, a traffic mix and a per-layer metric added as new
files are found by name from BENCHMARK.json, with no edit to the
harness."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

NEW_METRIC = '''"""Calls the harness issued in the traced window."""


def read(ctx):
    return float(ctx["steps"]) if ctx["steps"] else None
'''


def test_new_files_are_found(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(ROOT / "ompi_release_tpu_torch",
               tmp_path / "ompi_release_tpu_torch")
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "nccl_tests_8r.json").read_text())
    cfg["name"] = "nccl_tests_8r_copy"
    (b / "configs" / "nccl_tests_8r_copy.json").write_text(json.dumps(cfg))
    (b / "traffic" / "allreduce_tiny.json").write_text(json.dumps({
        "collective": "allreduce", "sizes_bytes_per_rank": [256, 4096],
        "sample_per_size": 2, "trace_blocks": 6}))
    (b / "metrics" / "calls_seen.py").write_text(NEW_METRIC)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "nccl_tests_8r_copy", "source": "https://example.org",
        "file": "benchmark/configs/nccl_tests_8r_copy.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({
        "name": "allreduce_tiny.nccl_tests_8r_copy",
        "config": "nccl_tests_8r_copy", "traffic": "allreduce_tiny",
        "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "calls_seen", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "dispatch",
        "moves": "busbw_GBps",
        "workloads": ["allreduce_tiny.nccl_tests_8r_copy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(b)!r}]\n"
        "import harness\n"
        "r = harness.run('allreduce_tiny.nccl_tests_8r_copy', 5, 0.1, True,"
        " t_start=time.perf_counter(), device='cpu')\n"
        "print(json.dumps(r))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert r["metrics"]["calls_seen"] == {"value": 12.0, "unit": "calls"}
