"""The port's observability command lines (``repro_torch.scripts.trace``,
``obs_merge`` and ``clear_autotune_cache``) against the reference's
``scripts/*.py``, in process.

The reference's scripts import neither ``jax`` nor ``repro.autotune``, so
they load here with ``importlib`` and run through their ``main()`` on a
patched ``sys.argv``.  The inputs are the port's exports of a reduced
TinyLlama prefill on two hosts (tracer, metrics, decision audit and
signature stream on; the DMA path and the tuner's ``ficco_autotune``),
and the reference's own exports of each kind.  The reference's
``audit --replay`` imports ``repro.autotune`` (ROADMAP R1), so the port's
replay is held to the tiers and schedules the audit log records.
"""

import dataclasses
import importlib.util
import json
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import machine as jmachine
from repro.core.schedule_types import Schedule as JSchedule
from repro.core.workload import GemmShape as JGemmShape
from repro.obs import audit as jaudit
from repro.obs import metrics as jmetrics
from repro.obs import sentinel as jsentinel
from repro.obs import signature as jsignature
from repro.obs import trace as jtrace
from repro_torch.autotune import reset_tuner
from repro_torch.configs import get_config
from repro_torch.configs.base import OverlapConfig
from repro_torch.models.model import build_model
from repro_torch.obs import audit, metrics, sentinel, signature
from repro_torch.obs import trace as _trace
from repro_torch.parallel.sharding import TPGroup, tp_group
from repro_torch.scripts import clear_autotune_cache, obs_merge
from repro_torch.scripts import trace as trace_cli
from repro_torch.serve.engine import make_prefill
from repro_torch.tune import registry

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HOSTS = (0, 1)
KINDS = ("trace", "metrics", "audit", "signature", "sentinel", "merged")


def _load_reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = {name: _load_reference(name)
       for name in ("trace", "obs_merge", "clear_autotune_cache")}
PORT = {"trace": trace_cli, "obs_merge": obs_merge,
        "clear_autotune_cache": clear_autotune_cache}


def _reset_port():
    reset_tuner()
    registry.reset_variants()
    audit.disable_audit()
    signature._STREAM = None
    _trace._TRACER = None
    metrics.reset_metrics()


@pytest.fixture(autouse=True)
def _fresh_port():
    _reset_port()
    yield
    _reset_port()


def _run(side: str, name: str, argv, capsys) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of one package's command line."""
    capsys.readouterr()
    if side == "port":
        code = PORT[name].main(list(argv))
    else:
        saved = sys.argv
        sys.argv = [f"{name}.py", *argv]
        try:
            REF[name].main()
            code = 0
        except SystemExit as e:
            code = e.code or 0
        finally:
            sys.argv = saved
    out = capsys.readouterr()
    return code, out.out, out.err


# ---------------------------------------------------------------------------
# The port's exports: a reduced TinyLlama prefill on two hosts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Per host: the trace, the metrics stream and the signature stream of
    two reduced prefills (DMA path, then ``ficco_autotune``) on a group of
    4; one audit log and one tuner store beside it for both hosts."""
    root = tmp_path_factory.mktemp("exports")
    cache_dir = root / "cache"
    saved = {k: os.environ.get(k) for k in
             ("REPRO_AUTOTUNE_CACHE_DIR", "REPRO_HOST_INDEX")}
    os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = str(cache_dir)
    cfg = get_config("tinyllama-1.1b").reduced()
    state = build_model(cfg).init(0, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))}
    prefills = [make_prefill(build_model(dataclasses.replace(
        cfg, overlap=OverlapConfig(**kw)))) for kw in (
            dict(mode="uniform-fused-1d", backend="dma"),
            dict(mode="ficco_autotune", backend="collective"))]
    files = {}
    try:
        _reset_port()
        audit.enable_audit()
        for host in HOSTS:
            os.environ["REPRO_HOST_INDEX"] = str(host)
            paths = {kind: str(root / f"host{host}.{kind}")
                     for kind in ("trace", "metrics", "signature")}
            _trace.enable(paths["trace"])
            signature.enable_signatures(paths["signature"])
            metrics.reset_metrics()
            with torch.no_grad(), tp_group(TPGroup(4, "cpu")):
                for run in prefills:
                    run(state, batch)
            _trace.disable()
            signature.disable_signatures()
            metrics.get_metrics().export_jsonl(paths["metrics"],
                                               reservoir=True)
            files[host] = paths
        audit.disable_audit()
    finally:
        _reset_port()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    files["audit"] = str(cache_dir / audit.AUDIT_FILENAME)
    files["cache_dir"] = str(cache_dir)
    return files


def test_exports_hold_the_prefills(exports):
    recs = audit.read_audit(exports["audit"])
    # Host 0's tuner decides each site's key once and reads it back from
    # its memory after; host 1 does the same.
    sources = {r["source"] for r in recs}
    assert recs and sources <= {"analytic", "cache"} and "analytic" in sources
    for host in HOSTS:
        with open(exports[host]["trace"]) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        assert "overlap/resolve" in names
        snap = json.loads(open(exports[host]["metrics"]).read())
        assert snap["host"]["host_index"] == host
        assert snap["counters"]["overlap/resolve.autotune"] > 0


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("machine", ["tpu-v5e-axis16", "mi300x-8"])
def test_timeline_matches_reference(machine, tmp_path, capsys):
    out = str(tmp_path / "timeline.json")
    argv = ["timeline", "--scenario", "g1", "g4", "--schedule", "all",
            "--machine", machine, "--out", out]
    got = {}
    for side in ("ref", "port"):
        code, stdout, stderr = _run(side, "trace", argv, capsys)
        assert code == 0, stderr
        with open(out) as f:
            got[side] = (stdout, json.load(f))
    assert got["port"][0] == got["ref"][0]
    assert "8 timelines" in got["port"][0]
    port, ref = got["port"][1], got["ref"][1]
    assert port["traceEvents"] == ref["traceEvents"]
    assert port.keys() == ref.keys()
    assert port["host"] == ref["host"]  # one process: the same stamp


def test_timeline_takes_the_h100_and_refuses_an_unknown_machine(tmp_path,
                                                                capsys):
    out = str(tmp_path / "t.json")
    code, stdout, _ = _run("port", "trace", [
        "timeline", "--machine", "h100-sxm-8", "--gemm", "2048", "5632",
        "2048", "--out", out], capsys)
    assert code == 0 and "gemm 2048x5632x2048" in stdout
    with pytest.raises(SystemExit, match="h100-sxm-8"):
        trace_cli.main(["timeline", "--machine", "nope", "--gemm", "1", "1",
                        "1", "--out", out])


# ---------------------------------------------------------------------------
# validate: every kind, both ways, and a corrupted file
# ---------------------------------------------------------------------------


def _jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _sentinel_events(mod):
    s = mod.Sentinel(mod.SentinelConfig(min_samples=2))
    for _ in range(6):
        s.observe_residual(1.0, 3.0)
    s.record_refit({"fit_sigma": 0.1}, trigger="drift")
    return s


def _port_file(kind, exports, path):
    """A file of ``kind`` that the port wrote."""
    if kind == "trace":
        return exports[0]["trace"]
    if kind in ("metrics", "signature"):
        return exports[0][kind]
    if kind == "audit":
        return exports["audit"]
    if kind == "sentinel":
        _sentinel_events(sentinel).export_jsonl(path)
        return path
    snaps = [json.loads(open(exports[h]["metrics"]).read()) for h in HOSTS]
    with open(path, "w") as f:
        json.dump(metrics.merge_snapshots(snaps), f)
    return path


def _ref_file(kind, exports, path):
    """A file of ``kind`` that the reference wrote."""
    if kind == "trace":
        tr = jtrace.Tracer(path)
        tr.name_process(1, "reference")
        with tr.span("serve/run", "serve", batch=2):
            tr.instant("mark", "serve")
        return tr.export()
    if kind in ("metrics", "merged"):
        snaps = []
        for host in HOSTS:
            reg = jmetrics.MetricsRegistry()
            reg.counter("tuner/decisions").inc(3 + host)
            for v in (1e-4, 2e-4, 5e-4):
                reg.histogram("tuner/pick_seconds").observe(v)
            snaps.append(reg.snapshot(reservoir=True,
                                      host={"host_index": host}))
        if kind == "metrics":
            _jsonl(path, snaps)
        else:
            with open(path, "w") as f:
                json.dump(jmetrics.merge_snapshots(snaps), f)
        return path
    if kind == "signature":
        stream = jsignature.SignatureStream(path)
        for sched in (JSchedule.SERIAL, JSchedule.UNIFORM_FUSED_2D):
            stream.observe_decision(JGemmShape(2048, 5632, 2048, 2),
                                    jmachine.MI300X, sched, group=8,
                                    source="analytic")
        stream.export_jsonl()
        return path
    if kind == "sentinel":
        _sentinel_events(jsentinel).export_jsonl(path)
        return path
    log = jaudit.AuditLog(path)  # the port's decisions, written by the
    for rec in audit.read_audit(exports["audit"]):  # reference's writer
        log.record({k: v for k, v in rec.items() if k != "ts"})
    return path


def _corrupt(kind, src, dst):
    """``src`` with one field broken, so its kind's validator refuses it."""
    if kind in ("trace", "merged"):
        obj = json.load(open(src))
        if kind == "trace":
            del obj["traceEvents"][-1]["ts"]
        else:
            obj["hosts"] = 0
        with open(dst, "w") as f:
            json.dump(obj, f)
        return dst
    recs = [json.loads(line) for line in open(src) if line.strip()]
    if kind in ("metrics", "signature"):
        recs[0]["ts"] = "later"
    else:
        recs[0]["kind"] = "bogus"
    _jsonl(dst, recs)
    return dst


@pytest.mark.parametrize("kind", KINDS)
def test_validate_both_ways_and_refuses_a_corrupted_file(kind, exports,
                                                         tmp_path, capsys):
    files = {"port": _port_file(kind, exports, str(tmp_path / "p")),
             "ref": _ref_file(kind, exports, str(tmp_path / "r"))}
    for writer, path in files.items():
        for side in ("ref", "port"):
            code, stdout, stderr = _run(
                side, "trace", ["validate", path, "--kind", kind], capsys)
            assert (code, stdout) == (0, f"{path}: valid {kind}\n"), (
                writer, side, stderr)
        bad = _corrupt(kind, path, str(tmp_path / f"bad-{writer}"))
        results = [_run(side, "trace", ["validate", bad, "--kind", kind],
                        capsys) for side in ("ref", "port")]
        assert results[0] == results[1]
        assert results[0][0] == 1 and "invalid: " in results[0][2]


# ---------------------------------------------------------------------------
# metrics, signature, audit: the same lines on the same files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sub", ["metrics", "signature", "audit"])
def test_summaries_match_reference(sub, exports, capsys):
    paths = ([exports["audit"]] if sub == "audit"
             else [exports[h][sub] for h in HOSTS])
    for path in paths:
        got = [_run(side, "trace", [sub, path], capsys)
               for side in ("ref", "port")]
        assert got[0] == got[1]
        code, stdout, _ = got[1]
        assert code == 0 and stdout
    if sub == "metrics":
        assert "tier rates: " in stdout
    if sub == "signature":
        assert "h100" in stdout and "serial" in stdout


def test_audit_replay_reproduces_the_logged_decisions(exports, capsys,
                                                      monkeypatch):
    """The default path (``decisions-torch.jsonl`` beside the port's
    cache) and ``--replay``: every analytic and cache record re-derived,
    none mismatched."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", exports["cache_dir"])
    recs = audit.read_audit(exports["audit"])
    code, stdout, stderr = _run("port", "trace", ["audit", "--replay"],
                                capsys)
    assert code == 0, stderr
    lines = stdout.splitlines()
    for r, line in zip(recs, lines):
        assert line.split() == [
            r["kind"], r["machine"], f"g{r['group']}", f"m{r['m']}",
            f"n{r['n']}", f"k{r['k']}", "->", r["schedule"],
            f"[{r['source']}]"]
    res = json.loads("\n".join(lines[len(recs):]))
    assert res == {"total": len(recs), "replayed": len(recs),
                   "matched": len(recs), "ok": True, "mismatches": [],
                   "skipped": []}


def test_audit_without_a_log_exits_1(tmp_path, capsys):
    code, _, stderr = _run("port", "trace",
                           ["audit", str(tmp_path / "none.jsonl")], capsys)
    assert code == 1 and "no audit log at" in stderr


# ---------------------------------------------------------------------------
# obs_merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sub", ["metrics", "traces"])
def test_obs_merge_matches_reference_byte_for_byte(sub, exports, tmp_path,
                                                   capsys):
    kind = "metrics" if sub == "metrics" else "trace"
    inputs = [exports[h][kind] for h in HOSTS]
    outs, logs = {}, {}
    for side in ("ref", "port"):
        out = str(tmp_path / f"{side}.json")
        code, _, logs[side] = _run(side, "obs_merge",
                                   [sub, *inputs, "--out", out], capsys)
        assert code == 0, logs[side]
        outs[side] = open(out, "rb").read()
    assert outs["port"] == outs["ref"]
    assert logs["port"] == logs["ref"]
    merged = json.loads(outs["port"])
    if sub == "metrics":
        snaps = [json.loads(open(p).read()) for p in inputs]
        assert merged["hosts"] == 2
        assert merged["counters"] == {
            k: sum(s["counters"].get(k, 0) for s in snaps)
            for k in set().union(*(s["counters"] for s in snaps))}
        assert metrics.validate_merged_snapshot(merged) == []
    else:
        traces = [json.load(open(p)) for p in inputs]
        assert merged == json.loads(json.dumps(_trace.merge_traces(traces)))
        assert _trace.validate_trace(merged) == []


def test_obs_merge_refuses_an_invalid_input(exports, tmp_path, capsys):
    bad = _corrupt("metrics", exports[0]["metrics"], str(tmp_path / "bad"))
    got = [_run(side, "obs_merge", ["metrics", bad], capsys)
           for side in ("ref", "port")]
    assert got[0] == got[1] and got[1][0] == 1


# ---------------------------------------------------------------------------
# clear_autotune_cache
# ---------------------------------------------------------------------------


def test_clear_autotune_cache_removes_only_its_own_store(tmp_path, capsys):
    store = {"port": "autotune-torch-v2.json", "ref": "autotune-v2.json"}
    others = ("decisions-torch.jsonl", "decisions.jsonl",
              "signatures-torch.jsonl")
    for name in store.values():
        (tmp_path / name).write_text(json.dumps(
            {"schema": 2, "entries": {"a": {}, "b": {}}}))
    for name in others:
        (tmp_path / name).write_text("{}\n")
    everything = sorted(os.listdir(tmp_path))
    for side in ("port", "ref"):
        path = tmp_path / store[side]
        code, stdout, _ = _run(side, "clear_autotune_cache",
                               ["--dir", str(tmp_path), "-n"], capsys)
        assert (code, stdout) == (0, f"would remove {path} (2 entries)\n")
        assert sorted(os.listdir(tmp_path)) == everything
    for side in ("port", "ref"):
        path = tmp_path / store[side]
        code, stdout, _ = _run(side, "clear_autotune_cache",
                               ["--dir", str(tmp_path)], capsys)
        assert (code, stdout) == (0, f"removed {path} (2 entries)\n")
        assert not path.exists()
    assert sorted(os.listdir(tmp_path)) == sorted(others)
    code, stdout, _ = _run("port", "clear_autotune_cache",
                           ["--dir", str(tmp_path)], capsys)
    assert code == 0 and stdout.startswith("nothing to clear")


def test_clear_autotune_cache_defaults_to_the_port_cache_dir(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", str(tmp_path))
    (tmp_path / "autotune-torch-v2.json").write_text("not json")
    code, stdout, _ = _run("port", "clear_autotune_cache", [], capsys)
    assert (code, stdout) == (
        0, f"removed {tmp_path / 'autotune-torch-v2.json'} (? entries)\n")


@pytest.mark.parametrize("name", sorted(PORT))
def test_modules_run_as_command_lines(name, exports, capsys, monkeypatch):
    """``python -m repro_torch.scripts.<name>`` exits with ``main``'s
    code (run in process: ``runpy`` as ``__main__``)."""
    argv = {"trace": ["validate", exports[0]["trace"]],
            "obs_merge": ["traces", exports[0]["trace"]],
            "clear_autotune_cache": ["-n", "--dir", exports["cache_dir"]]}
    for args, want in ((argv[name], 0), (["--no-such-flag"], 2)):
        monkeypatch.setattr(sys, "argv", [name, *args])
        # As a fresh ``python -m`` finds it: not imported yet.
        monkeypatch.delitem(sys.modules, f"repro_torch.scripts.{name}",
                            raising=False)
        with pytest.raises(SystemExit) as exc:
            runpy.run_module(f"repro_torch.scripts.{name}",
                             run_name="__main__")
        assert exc.value.code == want
