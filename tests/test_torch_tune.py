"""The port's kernel-variant search (``repro_torch.tune``) against the
reference's ``repro.tune``, in process: ``repro.tune``'s enumeration,
pruning and cost model import no JAX.

Enumeration, pruning (with its reasons), the variant cost model, digests
and payloads are held equal (bit for bit for the model's seconds) on the
reference's machines and the port's H100 model at Table I's shapes; the
registry's resolution order, the search end to end on the cost model, and
the K3 composer and K4 resolving ``variant=None`` through the registry are
checked on the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import machine as jmachine
from repro.core import workload as jworkload
from repro.tune import cost as jcost
from repro.tune import prune as jprune
from repro.tune import variants as jvariants
from repro_torch.autotune import (
    AutotuneCache,
    Autotuner,
    reset_tuner,
    set_tuner,
)
from repro_torch.core.machine import H100_SXM, MI300X, TPU_V5E
from repro_torch.core.workload import TABLE_I, GemmShape, StepProfile
from repro_torch.kernels import dma_exchange, ficco_ag_matmul
from repro_torch.kernels.ref import ag_matmul_ref
from repro_torch.obs import audit, metrics, signature
from repro_torch.tune import (
    KERNEL_SCHEDULE,
    KERNELS,
    KernelVariant,
    default_variant,
    enumerate_variants,
    prune_variants,
    registry,
    search_kernel_variants,
    variant_cost,
)

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

MACHINES = (MI300X, TPU_V5E, H100_SXM)
GROUPS = (None, 4, 8)
# Table I's GEMMs, and shapes that trip each of the pruner's rules
# (indivisible by the group or by the chunks, a chunk under one DMA
# granule, a footprint over the fast memory).
SHAPES = [sc.gemm for sc in TABLE_I] + [
    GemmShape(8 * 9, 256, 64, 2),
    GemmShape(64, 64, 8, 2),
    GemmShape(65536, 65536, 65536, 4),
]


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """The port's process-wide tuner, promotions, audit log and signature
    stream (``tests/conftest.py`` resets the reference's only)."""

    def reset():
        reset_tuner()
        registry.reset_variants()
        audit.disable_audit()
        signature._STREAM = None
        metrics.reset_metrics()

    reset()
    yield
    reset()


def _ref_machine(port):
    kw = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    kw["topology"] = jmachine.Topology(port.topology.value)
    return jmachine.MachineSpec(**kw)


def _ref_gemm(g):
    return jworkload.GemmShape(g.m, g.n, g.k, g.dtype_bytes)


def _ref_variant(v):
    return jvariants.KernelVariant(**v.to_payload())


@pytest.mark.parametrize("machine", MACHINES, ids=lambda m: m.name)
def test_enumeration_defaults_and_digests_match_reference(machine):
    ref_m = _ref_machine(machine)
    for kernel in KERNELS:
        for g in GROUPS:
            got = enumerate_variants(kernel, machine, group=g)
            want = jvariants.enumerate_variants(kernel, ref_m, group=g)
            assert [v.to_payload() for v in got] == [
                v.to_payload() for v in want
            ], (kernel, g)
            assert [v.digest() for v in got] == [v.digest() for v in want]
            assert [v.key_segment for v in got] == [
                v.key_segment for v in want
            ]
            for v in got:
                assert KernelVariant.from_digest(kernel, v.digest()) == v
                assert KernelVariant.from_payload(v.to_payload()) == v
            for m in (machine, None):
                assert default_variant(kernel, m, group=g).to_payload() == (
                    jvariants.default_variant(
                        kernel, ref_m if m else None, group=g
                    ).to_payload()
                )
    assert {k: s.value for k, s in KERNEL_SCHEDULE.items()} == {
        k: s.value for k, s in jvariants.KERNEL_SCHEDULE.items()
    }


def test_default_tiles_on_h100_and_without_a_machine():
    assert default_variant("dma_exchange", H100_SXM, group=4).digest() == (
        "c4t128x128x256d2f"
    )
    assert default_variant("ficco_ag_matmul", group=4).digest() == (
        "c4t128x128x128d2f"
    )


def test_variant_validation_matches_reference():
    bad = [dict(kernel="nope"), dict(chunks=0), dict(buffer_depth=1),
           dict(dispatch_order="sideways"), dict(block_k=4)]
    base = dict(kernel="dma_exchange", chunks=4, block_m=128, block_n=128,
                block_k=128)
    for over in bad:
        kw = {**base, **over}
        with pytest.raises(ValueError) as got:
            KernelVariant(**kw)
        with pytest.raises(ValueError) as want:
            jvariants.KernelVariant(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="malformed"):
        KernelVariant.from_digest("dma_exchange", "c4t1x2")


@pytest.mark.parametrize("machine", MACHINES, ids=lambda m: m.name)
def test_pruning_and_cost_match_reference(machine):
    """Feasible sets and rejection reasons equal; every feasible variant's
    modelled seconds bit-equal, uniform and under a skewed profile."""
    ref_m = _ref_machine(machine)
    profile = StepProfile.from_weights([4.0, 1.0, 2.0, 1.0], name="skew")
    ref_profile = jworkload.StepProfile.from_weights([4.0, 1.0, 2.0, 1.0],
                                                     name="skew")
    reasons = set()
    for gemm in SHAPES:
        for kernel in KERNELS:
            for g in (4, 8):
                cands = enumerate_variants(kernel, machine, group=g)
                feas, rej = prune_variants(cands, gemm, machine, group=g)
                jfeas, jrej = jprune.prune_variants(
                    tuple(_ref_variant(v) for v in cands), _ref_gemm(gemm),
                    ref_m, group=g,
                )
                assert [v.digest() for v in feas] == [
                    v.digest() for v in jfeas
                ]
                assert [(r.variant.digest(), r.reason) for r in rej] == [
                    (r.variant.digest(), r.reason) for r in jrej
                ]
                reasons.update(r.reason.split(":")[0] for r in rej)
                for v, jv in zip(feas, jfeas):
                    assert variant_cost(v, gemm, machine, group=g) == (
                        jcost.variant_cost(jv, _ref_gemm(gemm), ref_m,
                                           group=g)
                    )
                    assert variant_cost(
                        v, gemm, machine, group=g, profile=profile
                    ) == jcost.variant_cost(
                        jv, _ref_gemm(gemm), ref_m, group=g,
                        profile=ref_profile,
                    )
    assert {"indivisible", "dma granule", "vmem"} <= reasons, reasons


def test_smoke_projection_prunes_nothing_on_h100():
    """The L2 as the fast-memory budget: at TinyLlama-1.1B's up/gate
    projection every enumerated variant of both kernels is feasible."""
    gemm = GemmShape(2048, 5632, 2048, 2)
    for kernel, n in (("dma_exchange", 18), ("ficco_ag_matmul", 12)):
        cands = enumerate_variants(kernel, H100_SXM, group=4)
        feas, rej = prune_variants(cands, gemm, H100_SXM, group=4)
        assert (len(cands), len(feas), rej) == (n, n, ())


def test_registry_resolution_order(tmp_path):
    """Exact family -> wildcard -> persisted artifact -> default."""
    cache = AutotuneCache(path=str(tmp_path / "c.json"))
    kernel = "dma_exchange"
    base = default_variant(kernel, group=4)
    a = dataclasses.replace(base, chunks=2)
    b = dataclasses.replace(base, chunks=8)
    c = dataclasses.replace(base, dispatch_order="reverse")
    assert registry.resolve_variant(kernel, group=4, cache=cache) == base
    assert registry.resolve_variant(kernel, H100_SXM, group=4,
                                    cache=cache) == default_variant(
        kernel, H100_SXM, group=4)
    # A persisted promotion from an earlier process.
    cache.put_artifact(registry.VARIANT_ARTIFACT_KIND,
                       registry.artifact_name("*", kernel, "uniform"),
                       c.to_payload())
    assert registry.resolve_variant(kernel, group=4, cache=cache) == c
    registry.reset_variants()
    registry.set_variant(kernel, a)  # the wildcard
    assert registry.resolve_variant(kernel, H100_SXM, cache=cache) == a
    registry.set_variant(kernel, b, family="h100-sxm-8")
    assert registry.resolve_variant(kernel, H100_SXM, cache=cache) == b
    assert registry.resolve_variant(kernel, MI300X, cache=cache) == a
    skew = StepProfile.from_weights([3.0, 1.0])
    assert registry.resolve_variant(kernel, H100_SXM, group=4, profile=skew,
                                    cache=cache) == default_variant(
        kernel, H100_SXM, group=4)
    registry.set_variant(kernel, None, family="h100-sxm-8")
    assert registry.resolve_variant(kernel, H100_SXM, cache=cache) == a
    with pytest.raises(ValueError, match="unknown kernel"):
        registry.resolve_variant("nope")


@pytest.mark.parametrize("kernel", ["dma_exchange", "ficco_ag_matmul"])
def test_search_end_to_end_on_the_cost_model(kernel, tmp_path):
    """The port's search against the reference's enumerate -> prune ->
    cost pipeline; records, promotion and its persistence."""
    machine = MI300X
    gemm = GemmShape(4096, 8192, 2048, 2)
    tuner = Autotuner(AutotuneCache(path=str(tmp_path / "c.json")),
                      audit=False)
    res = search_kernel_variants(kernel, gemm, machine, group=8, tuner=tuner)

    ref_m = _ref_machine(machine)
    cands = jvariants.enumerate_variants(kernel, ref_m, group=8)
    jfeas, jrej = jprune.prune_variants(cands, _ref_gemm(gemm), ref_m,
                                        group=8)
    want = [(v.digest(), jcost.variant_cost(v, _ref_gemm(gemm), ref_m,
                                            group=8)) for v in jfeas]
    assert [(v.digest(), t) for v, t in res.timings] == want
    assert (res.n_enumerated, res.n_feasible, len(res.rejected)) == (
        len(cands), len(jfeas), len(jrej))
    best = min(want, key=lambda vt: vt[1])
    assert (res.best.digest(), res.best_seconds) == best
    assert res.default == default_variant(kernel, machine, group=8)
    assert res.speedup == res.default_seconds / res.best_seconds >= 1.0

    # Variant-keyed records, the plain decision record, the promotion.
    for v, t in res.timings:
        key = f"mi300x-8/g8/m4096/n8192/k2048/b2/u8/v{v.digest()}"
        entry = tuner.cache.get(key)
        assert entry["source"] == "variant-model"
        assert entry["measured_total_s"] == t
    plain = tuner.cache.get("mi300x-8/g8/m4096/n8192/k2048/b2/u8")
    assert plain["schedule"] == "uniform-fused-1d"
    assert plain["source"] == "measured"
    assert plain["variant"] == res.best.digest()
    assert registry.resolve_variant(kernel, group=8) == res.best
    registry.reset_variants()
    reloaded = AutotuneCache(path=str(tmp_path / "c.json"))
    assert registry.resolve_variant(kernel, group=8, cache=reloaded) == (
        res.best)


def test_search_with_a_runner_records_measured(tmp_path):
    tuner = Autotuner(AutotuneCache(path=str(tmp_path / "c.json")),
                      persist=False, audit=False)
    gemm = GemmShape(2048, 5632, 2048, 2)
    seen = []

    def runner(v):
        seen.append(v)
        return 1e-3 / v.chunks

    res = search_kernel_variants("ficco_ag_matmul", gemm, group=4,
                                 tuner=tuner, runner=runner, promote=False)
    assert res.machine == "h100-sxm-8" and len(seen) == res.n_feasible == 12
    assert res.best.chunks == 8
    recs = [e for k, e in tuner.cache.entries.items() if "/v" in k]
    assert len(recs) == 12 and {e["source"] for e in recs} == {"measured"}
    assert tuner.cache.get("h100-sxm-8/g4/m2048/n5632/k2048/b2/u4") is None
    assert registry.resolve_variant("ficco_ag_matmul", group=4,
                                    cache=tuner.cache) == (
        default_variant("ficco_ag_matmul", group=4))


def _shards(g, m_s, k, n_local, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((g, m_s, k)).astype(np.float32))
    w = torch.from_numpy(
        rng.standard_normal((g, k, n_local)).astype(np.float32))
    return x, w


def test_kernels_resolve_variant_none_through_the_registry(monkeypatch,
                                                          tmp_path):
    """The K3 composer and K4 take the promoted variant when called with
    ``variant=None``: the composer runs its chunk count as exchange steps,
    K4 plans with it; both still match the plain all-gather + GEMM."""
    set_tuner(Autotuner(AutotuneCache(path=str(tmp_path / "c.json")),
                        audit=False))
    x, w = _shards(4, 16, 32, 8)
    want = ag_matmul_ref(x, w)
    steps, plans = [], []
    orig_exchange = dma_exchange.a2a_chunk_exchange
    orig_plan = ficco_ag_matmul._plan

    def exchange(*a, **kw):
        steps.append(1)
        return orig_exchange(*a, **kw)

    def plan(variant, g, m_s):
        plans.append(variant)
        return orig_plan(variant, g, m_s)

    monkeypatch.setattr(dma_exchange, "a2a_chunk_exchange", exchange)
    monkeypatch.setattr(ficco_ag_matmul, "_plan", plan)
    for chunks in (None, 8):
        if chunks is not None:
            for kernel in ("dma_exchange", "ficco_ag_matmul"):
                registry.set_variant(kernel, dataclasses.replace(
                    default_variant(kernel, group=4), chunks=chunks))
        steps.clear()
        got = dma_exchange.ficco_uniform_fused_1d_dma(x, w)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert len(steps) == (chunks or 4)
        torch.testing.assert_close(ficco_ag_matmul.ficco_ag_matmul_fused(
            x, w), want, rtol=1e-5, atol=1e-5)
        assert plans[-1].chunks == (chunks or 4)
