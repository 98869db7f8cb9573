"""The port's tracer and metrics vs the reference's: exports that pass the
reference's validators and merge with its exports, the serve engine's and
the schedule resolution's spans and counters under the reference's names,
and the ``REPRO_TRACE`` hook."""

import atexit
import importlib
import json
from collections import Counter

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.schedule_types import Schedule as JaxSchedule
from repro.models.model import build_model as jax_build_model
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro.overlap.api import resolve_schedule as jax_resolve_schedule
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.schedule_types import Schedule
from repro_torch.obs import metrics, trace
from repro_torch.overlap.api import resolve_schedule
from repro_torch.serve.engine import DecodeEngine, Request


@pytest.fixture(autouse=True)
def _fresh_obs():
    trace._TRACER = None
    metrics.reset_metrics()
    yield
    trace._TRACER = None
    metrics.reset_metrics()


def test_trace_export_passes_reference_validation_and_merges(tmp_path):
    path = tmp_path / "port.trace.json"
    tracer = trace.enable(str(path))
    tracer.name_process(1, "port")
    with trace.span("train/step", "train", step=0) as sp:
        sp.set(extra=1)
    trace.instant("mark", "train", why="test")
    trace.counter("tokens", 3.0)
    assert trace.disable() == str(path)
    port = json.loads(path.read_text())
    assert jax_trace.validate_trace(port) == []
    assert [e["name"] for e in port["traceEvents"]] == [
        "process_name", "train/step", "mark", "tokens"]
    assert port["traceEvents"][1]["args"] == {"step": 0, "extra": 1}
    ref = jax_trace.Tracer()
    with ref.span("serve/run", "serve"):
        pass
    for merge in (trace.merge_traces, jax_trace.merge_traces):
        merged = merge([port, ref.to_json()])
        assert jax_trace.validate_trace(merged) == []
        assert trace.validate_trace(merged) == []


def test_disabled_tracer_is_a_no_op():
    assert not trace.enabled()
    assert trace.span("x") is trace.NULL_SPAN
    trace.instant("x")
    trace.counter("x", 1.0)
    assert trace.disable() is None


def test_metrics_snapshot_passes_reference_validation(tmp_path):
    reg = metrics.get_metrics()
    ref = jax_metrics.MetricsRegistry()
    reg.counter("train/steps").inc(3)
    ref.counter("train/steps").inc(2)
    samples = np.random.default_rng(0).standard_normal(50).tolist()
    for v in samples:
        reg.histogram("step_seconds").observe(v)
        ref.histogram("step_seconds").observe(v)
    snap = reg.export_jsonl(str(tmp_path / "m.jsonl"), reservoir=True)
    assert jax_metrics.validate_snapshot(snap) == []
    line = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[0])
    assert line["counters"] == {"train/steps": 3}
    # The same observations give the reference's histogram exactly.
    got = snap["histograms"]["step_seconds"]
    want = ref.snapshot()["histograms"]["step_seconds"]
    assert {k: got[k] for k in want} == want
    ref_snap = ref.snapshot(reservoir=True, host={"host_index": 1})
    merged = metrics.merge_snapshots([snap, ref_snap])
    assert jax_metrics.validate_merged_snapshot(merged) == []
    assert merged["counters"]["train/steps"] == 5
    assert merged == jax_metrics.merge_snapshots([snap, ref_snap])


def test_decode_engine_spans_and_counters_match_reference():
    """The same requests through both engines: equal serve/steps and
    serve/tokens, and the same spans with the same args."""
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 3)).astype(np.int32)
    jax_tracer = jax_trace.enable()
    JaxDecodeEngine(jcfg, params, batch_size=2).run(
        [JaxRequest(prompts[0], 3), JaxRequest(prompts[1][:2], 2)])
    jax_trace.disable()
    cfg = get_config("tinyllama-1.1b").reduced()
    state = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    tracer = trace.enable()
    DecodeEngine(cfg, state, batch_size=2, device="cpu").run(
        [Request(prompts[0], 3), Request(prompts[1][:2], 2)])
    trace.disable()

    def counters(reg):
        return {k: v for k, v in reg.snapshot()["counters"].items()
                if k.startswith("serve/")}

    want = counters(jax_metrics.get_metrics())
    assert counters(metrics.get_metrics()) == want
    assert want["serve/tokens"] == 5 and want["serve/steps"] >= 3

    def spans(events):
        return [(e["name"], e["args"]) for e in events if e["ph"] == "X"]

    assert spans(tracer.events) == spans(jax_tracer.events)
    assert Counter(n for n, _ in spans(tracer.events)) == Counter(
        {"serve/step": want["serve/steps"], "serve/run": 1})


@pytest.mark.parametrize("schedule", [
    "explicit", "uniform-fused-2d", "auto",
])
def test_resolve_schedule_counts_like_reference(schedule):
    jax_tracer, tracer = jax_trace.enable(), trace.enable()
    port_arg, ref_arg = (
        (Schedule.SHARD_P2P, JaxSchedule.SHARD_P2P)
        if schedule == "explicit" else (schedule, schedule)
    )
    kw = dict(m=2048, n=5632, k=2048, group=4)
    got = resolve_schedule(port_arg, **kw)
    want = jax_resolve_schedule(ref_arg, **kw)
    if schedule != "auto":  # "auto" decides for another machine
        assert got.value == want.value
    how = {"explicit": "explicit", "auto": "auto"}.get(schedule, "named")
    assert metrics.get_metrics().snapshot()["counters"] == {
        f"overlap/resolve.{how}": 1}
    assert jax_metrics.get_metrics().snapshot()["counters"] == {
        f"overlap/resolve.{how}": 1}
    (port_span,) = [e for e in tracer.events if e["ph"] == "X"]
    (ref_span,) = [e for e in jax_tracer.events if e["ph"] == "X"]
    assert port_span["name"] == ref_span["name"] == "overlap/resolve"
    assert port_span["args"].keys() == ref_span["args"].keys()
    assert port_span["args"]["how"] == ref_span["args"]["how"] == how


def test_repro_trace_env_var_exports_at_exit(tmp_path, monkeypatch):
    """``REPRO_TRACE=path`` at import enables the tracer and registers an
    export at exit: the module is reloaded under the variable and the
    registered hook called in process."""
    path = tmp_path / "env.trace.json"
    hooks = []
    monkeypatch.setattr(atexit, "register", hooks.append)
    monkeypatch.setenv("REPRO_TRACE", str(path))
    try:
        importlib.reload(trace)
        assert trace.enabled() and hooks == [trace._export_at_exit]
        with trace.span("train/step", "train", step=0):
            pass
        hooks[0]()
    finally:
        monkeypatch.delenv("REPRO_TRACE")
        importlib.reload(trace)
    assert not trace.enabled()
    obj = json.loads(path.read_text())
    assert trace.validate_trace(obj) == []
    assert [e["name"] for e in obj["traceEvents"]] == ["train/step"]
