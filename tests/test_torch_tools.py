"""The port's remaining tools held against the JAX package's:
``tpu_top`` (its renderers and the ``--fleet-from`` / ``--tenants`` /
``--metrics`` modes), ``tpu_server`` with ``tpu_doctor collect``,
``tpu_bench_gate``, ``tpu_checkpoint``, ``tpu_clean`` and ``tpu_info``.

Renderers give the same text for the same documents; either package's
client reads the other's server; the gate's verdicts and exit codes
match on synthetic round files written to ``tmp_path``; the checkpoint
tool verifies, lists and shows a checkpoint the JAX package wrote, as
the JAX tool does; the cleaner makes the same decisions on one
``tmp_path`` tree; ``tpu_info --json`` names the same frameworks and
variables, apart from the listed names that differ by design.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from ompi_release_tpu.tools import tpu_bench_gate as jgate
from ompi_release_tpu.tools import tpu_checkpoint as jckpt
from ompi_release_tpu.tools import tpu_clean as jclean
from ompi_release_tpu.tools import tpu_server as jsrv
from ompi_release_tpu.tools import tpu_top as jtop
from ompi_release_tpu.tools import tpurun as jtpurun

from ompi_release_tpu_torch.tools import tpu_bench_gate as tgate
from ompi_release_tpu_torch.tools import tpu_checkpoint as tckpt
from ompi_release_tpu_torch.tools import tpu_clean as tclean
from ompi_release_tpu_torch.tools import tpu_doctor as tdoctor
from ompi_release_tpu_torch.tools import tpu_server as tsrv
from ompi_release_tpu_torch.tools import tpu_top as ttop
from ompi_release_tpu_torch.tools import tpurun as ttpurun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# ---------------------------------------------------------------------------
# tpu_top
# ---------------------------------------------------------------------------


def _series_docs(seed):
    """Per-process sampler documents from a seed: per-cid ops and bytes,
    latency histograms, skew, plan hits, ledger records, native and
    staged bytes, a stall and a desync on one process."""
    rng = np.random.RandomState(seed)
    docs = []
    for pidx in range(3):
        pts = []
        for k in range(12):
            t = 100.0 + 0.5 * k + 0.01 * pidx
            for cid in (0, 262144 + pidx):
                pts.append({"t": t, "cid": cid, "name": "coll_ops",
                            "v": int(rng.randint(1, 50))})
                pts.append({"t": t, "cid": cid, "name": "coll_bytes",
                            "v": int(rng.randint(1, 1 << 22))})
            pts.append({"t": t, "cid": 0, "name": "coll_allreduce_latency",
                        "v": {"buckets": {
                            str(b): int(rng.randint(0, 9))
                            for b in (1e-4, 1e-3, 1e-2, 0.1)}}})
            pts.append({"t": t, "cid": 0,
                        "name": "coll_allreduce_skew_seconds",
                        "v": {"sum": float(rng.uniform(0, 1e-3)),
                              "count": 4}})
            pts.append({"t": t, "cid": -1,
                        "name": "coll_compiled_cache_hits",
                        "v": {"sum": 3, "count": 4}})
            pts.append({"t": t, "cid": -1, "name": "ledger_records",
                        "v": 2})
            pts.append({"t": t, "cid": -1, "name": "wire_native_bytes",
                        "v": int(rng.randint(0, 1 << 20))})
            pts.append({"t": t, "cid": -1, "name": "wire_native_frames",
                        "v": 4})
            pts.append({"t": t, "cid": -1, "name": "btl_dcn_staged_bytes",
                        "v": 1 << 21})
            if pidx != 2:
                pts.append({"t": t, "cid": -1,
                            "name": "wire_native_ring_hwm_frac",
                            "v": 0.5})
        if pidx == 1:
            pts.append({"t": 104.0, "cid": -1,
                        "name": "obs_stalls_detected", "v": 1})
            pts.append({"t": 104.0, "cid": 0,
                        "name": "sentinel_mismatches", "v": 1})
        docs.append({"meta": {"pidx": pidx, "ranks": [2 * pidx,
                                                      2 * pidx + 1],
                              "host": f"h{pidx}", "push_age_s": 0.5},
                     "points": pts})
    return docs


TENANTS_DOC = {
    "capacity": {"ranks": 256, "lanes": 64, "used_ranks": 4,
                 "used_lanes": 1},
    "tenants": [{"tid": 1, "name": "lat-job", "qos": "latency",
                 "ranks": 4, "lanes": 1, "state": "live",
                 "evict_reason": None, "beat_age_s": 0.4,
                 "stats": {"coll_s": 57.0, "mb_s": 14.93,
                           "lane_share": 0.8, "hol_wait_s": 0.0012}}],
    "evicted": [{"tid": 0, "name": "bulk-job-with-a-long-name",
                 "qos": "bulk", "ranks": 6, "lanes": 1,
                 "state": "evicted", "beat_age_s": 12.6,
                 "evict_reason": "worker 2 died mid-allreduce",
                 "stats": {}}],
}


class TestTpuTop:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_fleet_renderers_equal_jax(self, seed):
        docs = _series_docs(seed)
        for d in docs:
            for window in (1.0, 15.0):
                assert ttop.summarize_points(d["points"], window) \
                    == jtop.summarize_points(d["points"], window)
        for window in (2.0, 15.0):
            assert ttop.render_fleet(docs, window) \
                == jtop.render_fleet(docs, window)
        assert ttop.render_fleet(docs, 15.0, stale_after_s=0.1) \
            == jtop.render_fleet(docs, 15.0, stale_after_s=0.1)
        assert ttop.summarize_points([]) == jtop.summarize_points([])

    def test_tenant_renderer_equals_jax(self):
        for doc in (TENANTS_DOC, {"tenants": [], "evicted": []}, {}):
            assert ttop.render_tenants(doc) == jtop.render_tenants(doc)
        text = ttop.render_tenants(TENANTS_DOC)
        assert "evicted (worker 2 died mid-allreduce)" in text

    def test_fleet_from_dumps(self, tmp_path):
        from ompi_release_tpu_torch.obs import doctor as tdoc

        for d in _series_docs(4):
            with open(tmp_path / f"series-p{d['meta']['pidx']}.jsonl",
                      "w") as f:
                f.write(json.dumps({"meta": d["meta"]}) + "\n")
                for p in d["points"]:
                    f.write(json.dumps(p) + "\n")
        assert len(tdoc.load_series_dir(str(tmp_path))) == 3
        assert ttop.fleet_from_dir(str(tmp_path)) \
            == jtop.fleet_from_dir(str(tmp_path))
        rc, text = _run(ttop.main, ["--fleet-from", str(tmp_path)])
        assert rc == 0 and text == ttop.fleet_from_dir(str(tmp_path)) + "\n"
        assert "no series-p" in ttop.fleet_from_dir(str(tmp_path / "x"))

    def test_bad_targets_exit_2(self):
        for mode in ("--tenants", "--metrics"):
            argv = [mode, "nonsense", "--iterations", "1"]
            assert ttop.main(argv) == jtop.main(argv) == 2


# ---------------------------------------------------------------------------
# tpu_server and tpu_doctor collect
# ---------------------------------------------------------------------------


class TestTpuServer:
    @pytest.mark.parametrize("pair", ["torch-server", "jax-server"])
    def test_names_and_rpcs_across_packages(self, pair):
        srv_mod, cl_mod = ((tsrv, jsrv) if pair == "torch-server"
                           else (jsrv, tsrv))
        srv = srv_mod.NameServer()
        a = cl_mod.NameClient("127.0.0.1", srv.port)
        b = srv_mod.NameClient("127.0.0.1", srv.port)
        try:
            a.publish("svc-x", "tpu-port:0.1", ttl_s=60)
            assert b.lookup("svc-x", timeout_ms=5000) == "tpu-port:0.1"
            page = b.metrics()
            assert "# TYPE ompitpu_" in page
            assert isinstance(a.journal()["spans"], list)
            assert "points" in a.series()
            a.unpublish("svc-x")
            with pytest.raises(Exception):
                b.lookup("svc-x", timeout_ms=200)
        finally:
            a.close()
            b.close()
            srv.shutdown()

    def test_doctor_collect_against_the_port_server(self, tmp_path):
        from ompi_release_tpu_torch import obs

        srv = tsrv.NameServer()
        was = obs.enabled
        obs.enable()
        try:
            obs.record("collect_probe", "coll", 1.0, 0.001, nbytes=64)
            rc, text = _run(tdoctor.main, [
                "collect", f"127.0.0.1:{srv.port}", "-o",
                str(tmp_path), "--metrics"])
            assert rc == 0 and "spans from" in text
            with open(tmp_path / "journal-p0.json") as f:
                dump = json.load(f)
            assert any(s["op"] == "collect_probe"
                       for s in dump["spans"])
            assert (tmp_path / "metrics-p0.prom").read_text().startswith(
                "# ")
            rc, text = _run(ttop.main, ["--metrics",
                                        f"127.0.0.1:{srv.port}",
                                        "--iterations", "1"])
            assert rc == 0 and "# TYPE ompitpu_" in text
        finally:
            if not was:
                obs.disable()
            obs.journal.clear()
            srv.shutdown()
        assert tdoctor.main(["collect", "no-port-here"]) == 2


# ---------------------------------------------------------------------------
# tpu_bench_gate
# ---------------------------------------------------------------------------


def _round(path, lines, wrap=False):
    text = "\n".join(json.dumps(ln) for ln in lines)
    if wrap:  # a driver round record: the bench's stdout in "tail"
        text = json.dumps({"tail": "jax warning\n" + text})
    path.write_text(text)
    return str(path)


def _gate_files(tmp_path, seed, regress):
    rng = np.random.RandomState(seed)
    files = []
    for r in range(5):
        lines = [
            {"metric": "op_sum_256MiB_f32_hbm_bw", "unit": "GB/s",
             "value": float(rng.uniform(2900, 3100))},
            {"metric": "ring_hop_us", "unit": "us/hop",
             "value": float(rng.uniform(5, 6))},
            {"metric": "sim_bcast_root_sends_p64", "unit": "msgs",
             "value": 6, "tier_label": "sim"},
            {"metric": "tenant_latency_isolation_p256",
             "unit": "p99_ratio", "value": 1.08, "tier_label": "sim"},
            {"metric": "steady_obs_overhead_spanning_allreduce_256KiB",
             "unit": "ratio", "value": float(rng.uniform(1.0, 1.1))},
            {"metric": "unstable_line", "unit": "GB/s", "value": 1.0,
             "unstable": True},
            {"metric": "null_line", "unit": "GB/s", "value": None},
        ]
        if r == 4 and regress:
            lines[0]["value"] = 900.0  # a halved bandwidth
            lines[3]["value"] = 1.6  # the isolation bound blown
        files.append(_round(tmp_path / f"BENCH_r{r:02d}.json", lines,
                            wrap=r % 2 == 0))
    return files


class TestBenchGate:
    @pytest.mark.parametrize("regress", [False, True])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_verdicts_and_exit_codes_equal_jax(self, tmp_path, seed,
                                               regress):
        files = _gate_files(tmp_path, seed, regress)
        for k, argv in enumerate((
                files, files + ["--json"],
                files[:-1] + ["--candidate", files[-1], "--min-rounds",
                              "2"],
                files + ["--sigma", "1", "--rel-floor", "0.01"])):
            t = _run(tgate.main, argv)
            j = _run(jgate.main, argv)
            assert t == j
            if k < 3:  # the last, a tight band, may trip on noise
                assert t[0] == (1 if regress else 0)
        rounds = [tgate.parse_round_file(p) for p in files[:-1]]
        cand = tgate.parse_round_file(files[-1])
        assert tgate.evaluate(rounds, cand) == jgate.evaluate(
            [jgate.parse_round_file(p) for p in files[:-1]],
            jgate.parse_round_file(files[-1]))
        for ln in cand:
            assert tgate.gateable(ln) == jgate.gateable(ln)
            assert tgate.line_tier(ln) == jgate.line_tier(ln)

    def test_too_few_rounds_exit_2(self, tmp_path):
        one = _gate_files(tmp_path, 0, False)[:1]
        assert _run(tgate.main, one)[0] == 2 == _run(jgate.main, one)[0]


# ---------------------------------------------------------------------------
# tpu_checkpoint
# ---------------------------------------------------------------------------


class TestTpuCheckpoint:
    def test_verify_list_show_on_a_jax_checkpoint(self, tmp_path):
        import jax.numpy as jnp

        from ompi_release_tpu.ft.checkpoint import Checkpointer

        rng = np.random.RandomState(0)
        ck = Checkpointer(str(tmp_path))
        for step in (3, 7):
            state = {"w": jnp.asarray(rng.randn(64, 32).astype(np.float32)),
                     "b": jnp.asarray(rng.randn(32).astype(np.float32)),
                     "step": jnp.asarray(step, dtype=jnp.int32)}
            ck.save(step, state, extra_meta={"loss": 1.5 + step})
        ck.wait()
        for argv in (["list", str(tmp_path)], ["show", str(tmp_path)],
                     ["show", str(tmp_path), "--step", "3"],
                     ["verify", str(tmp_path)],
                     ["verify", str(tmp_path), "--step", "3"]):
            t = _run(tckpt.main, argv)
            assert t == _run(jckpt.main, argv), argv
            assert t[0] == 0
        assert "3 leaves verified OK" in _run(tckpt.main,
                                               ["verify", str(tmp_path)])[1]
        # bit rot in one shard: both tools fail the step
        step_dir = tmp_path / "step_0000000007"
        shard = sorted(p for p in step_dir.iterdir()
                       if p.name.startswith("leaf0000"))[-1]
        raw = bytearray(shard.read_bytes())
        raw[-1] ^= 0xFF
        shard.write_bytes(bytes(raw))
        t = _run(tckpt.main, ["verify", str(tmp_path)])
        assert t[0] == 1 and "FAILED" in t[1]
        assert t[0] == _run(jckpt.main, ["verify", str(tmp_path)])[0]
        rc, text = _run(tckpt.main, ["gc", str(tmp_path), "--keep", "1"])
        assert rc == 0 and "removed step 3" in text
        (tmp_path / "empty").mkdir()
        assert _run(tckpt.main, ["list", str(tmp_path / "empty")]) \
            == (1, "no committed checkpoints\n")


# ---------------------------------------------------------------------------
# tpu_clean
# ---------------------------------------------------------------------------


def _clean_tree(sess, prefix):
    from multiprocessing import shared_memory

    sess.mkdir()
    (sess / "111.json").write_text(json.dumps({"pid": 2 ** 22 + 17}))
    (sess / "live.json").write_text(json.dumps({"pid": os.getpid()}))
    (sess / "junk.json").write_text("{not json")
    (sess / "nullpid.json").write_text('{"pid": null}')
    (sess / "list.json").write_text("[1, 2]")
    (sess / "notes.txt").write_text("not a session file")
    return [shared_memory.SharedMemory(create=True, size=64, name=name)
            for name in (f"{prefix}{2 ** 22 + 19}-dead",
                         f"{prefix}{os.getpid()}-live",
                         f"{prefix}{2 ** 22 + 23}-fresh",
                         f"{prefix}notapid-x")]


class TestTpuClean:
    def test_decisions_equal_jax(self, tmp_path, monkeypatch):
        from multiprocessing import shared_memory

        prefix = f"omtstt{os.getpid()}-"
        sess = tmp_path / "sessions"
        segs = _clean_tree(sess, prefix)
        monkeypatch.setattr(ttpurun, "SESSION_DIR", str(sess))
        monkeypatch.setattr(jtpurun, "SESSION_DIR", str(sess))
        try:
            kw = dict(min_age_s=0.0, shm_prefix=prefix)
            outs = {}
            for name, mod in (("jax", jclean), ("torch", tclean)):
                buf = io.StringIO()
                counts = mod.clean(dry_run=True, verbose=True, out=buf,
                                   **kw)
                outs[name] = (counts, sorted(buf.getvalue().splitlines()))
            assert outs["torch"] == outs["jax"]
            assert outs["torch"][0] == (4, 2)
            assert tclean.clean(dry_run=True, min_age_s=3600.0,
                                shm_prefix=prefix)[1] == 0
            assert tclean.clean(min_age_s=0.0, shm_prefix=prefix) == (4, 2)
            assert sorted(p.name for p in sess.iterdir()) \
                == ["live.json", "notes.txt"]
            for seg in (segs[0], segs[2]):
                with pytest.raises(FileNotFoundError):
                    shared_memory.SharedMemory(name=seg.name)
            shared_memory.SharedMemory(name=segs[1].name).close()
        finally:
            for seg in segs:
                seg.close()
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass

    def test_segment_pattern_and_session_dir_match_the_port(self):
        assert tclean.SHM_PREFIX == "ompitpu-"
        assert ttpurun.SESSION_DIR.endswith(
            f"ompitpu-sessions-{os.getuid()}")

    def test_cli_reports_counts(self, tmp_path, monkeypatch):
        monkeypatch.setattr(ttpurun, "SESSION_DIR", str(tmp_path / "s"))
        rc, text = _run(tclean.main, ["--dry-run", "--min-age", "3600"])
        assert rc == 0 and text.startswith("tpu-clean: would remove 0")


# ---------------------------------------------------------------------------
# tpu_info
# ---------------------------------------------------------------------------

#: names that differ between the packages by design: the op and coll
#: components (CUDA kernels and the fused one-card body in place of
#: Pallas and XLA), and the port's own variables and counters
INFO_DIFFERS = {
    "components": {("op", "pallas"), ("op", "xla"), ("op", "cuda"),
                   ("op", "torch"), ("coll", "xla"), ("coll", "fused")},
    "variables": {"coll_tuning_db_dir", "runtime_virtual_ranks"},
    "pvars": {"tuning_db_resolves", "vprotocol_logged_recvs",
              "vprotocol_logged_sends", "wire_native_device_staged_bytes",
              "wire_native_reaped_bytes",
              # the port's device-time spans and kernel counters
              "coll_plan_copy_device_seconds", "coll_plan_copy_bytes",
              "coll_plan_launch_seconds", "coll_runner_device_seconds",
              "coll_fusion_pack_device_seconds", "device_timer_dropped",
              "op_stream_axpy_bytes",
              "op_sum_launches", "op_axpy_launches", "op_scale_launches",
              "op_transpose_launches", "op_chain_launches",
              "op_flash_fwd_launches", "op_flash_bwd_dq_launches",
              "op_flash_bwd_dkv_launches", "op_ring_fold_launches"},
}


def _info(pkg):
    import subprocess

    r = subprocess.run([sys.executable, "-m", f"{pkg}.tools.tpu_info",
                        "--json"], cwd=REPO, capture_output=True,
                       text=True, timeout=240,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


class TestTpuInfo:
    def test_json_names_equal_jax_apart_from_the_listed_ones(self):
        t, j = _info("ompi_release_tpu_torch"), _info("ompi_release_tpu")
        assert t["package"] == "ompi_release_tpu_torch"
        assert t["devices"] == [{"id": 0, "platform": "cpu", "kind": "cpu",
                                 "process": 0, "memory_bytes": None}]
        comps = {}
        for name, info in (("torch", t), ("jax", j)):
            comps[name] = {(fw["name"], c["name"])
                           for fw in info["frameworks"]
                           for c in fw["components"]}
        diff = INFO_DIFFERS["components"]
        assert comps["torch"] - diff == comps["jax"] - diff
        assert {f["name"] for f in t["frameworks"]} \
            == {f["name"] for f in j["frameworks"]}
        for key in ("variables", "pvars"):
            tn = ({v["name"] for v in t[key]} if key == "variables"
                  else set(t[key]))
            jn = ({v["name"] for v in j[key]} if key == "variables"
                  else set(j[key]))
            assert tn - INFO_DIFFERS[key] == jn - INFO_DIFFERS[key]

    def test_text_renders_every_framework(self):
        from ompi_release_tpu_torch.tools import tpu_info as tinfo

        info = tinfo.gather(include_vars=True)
        text = tinfo.render_text(info, show_vars=True)
        for fw in info["frameworks"]:
            assert fw["name"] in text
        assert "Config variables (MCA):" in text
