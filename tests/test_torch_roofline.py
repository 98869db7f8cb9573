"""The port's roofline counters (``repro_torch.roofline``) against the
reference's, for every arch in the registry at full width.

``forward_costs`` and ``Costs`` run in this process on both sides and must
agree bit for bit.  The reference's ``count_params`` traces its whole
``Model.init`` with ``jax.eval_shape``; it runs in the session's one JAX
subprocess (its ``counts`` entry, ``tests/torch_jax_reference.py``), and
``step_costs``, ``active_params`` and ``model_flops_for`` run on both
sides in this process with the reference's ``count_params`` returning
those counts.  The port counts on the ``"meta"`` device: no weight is
allocated or drawn.

The three-term :class:`Roofline` holds the H100's data-sheet constants;
with the reference's TPU constants set to the same values, its
properties and ``to_dict`` equal the reference's.  The collectives that
``collectives.counting()`` records in each schedule's forward on 4 logical
ranks, and in ``serial_a2a_ffn``'s, equal ``parse_collectives`` of the
reference's compiled ``shard_map`` forward on 4 forced host devices (the
subprocess's ``collectives`` entry): bytes and calls by kind.
"""

import dataclasses
import math

import pytest
import torch
import torch_jax_reference as jax_reference

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.roofline import analysis as jax_analysis
from repro.roofline import counters as jax_counters
from repro_torch import roofline
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, OverlapConfig
from repro_torch.core.machine import H100_SXM
from repro_torch.core.schedule_types import Schedule
from repro_torch.models.model import build_model
from repro_torch.overlap import serial_a2a_ffn
from repro_torch.overlap.schedules import SCHEDULE_FNS
from repro_torch.parallel.collectives import counting
from repro_torch.parallel.context import overlap_context
from repro_torch.parallel.sharding import TPGroup, tp_group
from repro_torch.roofline import analysis
from repro_torch.train.loop import loss_and_grads
from repro_torch.tree import leaves

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

ALL_ARCHS = sorted(ARCHS)
KINDS = ("train", "prefill", "decode")


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the in-process tests run."""
    jax_reference.start(tmp_path_factory)


@pytest.fixture(scope="module")
def reference_counts(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory, entry="counts")


@pytest.fixture(scope="module")
def reference_collectives(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory,
                                   entry="collectives")


@pytest.fixture
def counted(reference_counts, monkeypatch):
    """The reference's counters with its ``count_params`` taken from the
    subprocess's counts (the rest of its arithmetic runs here)."""
    monkeypatch.setattr(jax_analysis, "count_params",
                        lambda cfg: reference_counts[cfg.name])
    return reference_counts


def _same(got, want):
    assert (got.flops, got.bytes) == (want.flops, want.bytes)


def test_costs_arithmetic():
    a, b = roofline.Costs(1.0, 2.0), roofline.Costs(3.0, 5.0)
    assert (a + b).flops == 4.0 and (a + b).bytes == 7.0
    assert (2 * a).flops == (a * 2).flops == 2.0 and (2 * a).bytes == 4.0
    assert roofline.Costs() == roofline.Costs(0.0, 0.0)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_costs_match_reference(arch):
    """Training, prefill and decode (context the shape's length, and one
    longer than a sliding window) at every assigned shape, and at the
    cards' 4 x 512 prefill."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    cases = [(4, 512, {}), (1, 1, dict(ctx=8192, decode=True))]
    for name, shape in SHAPES.items():
        b, s = shape.global_batch, shape.seq_len
        cases.append((b, s, {}))
        cases.append((b, 1, dict(ctx=s, decode=True)))
    for b, s, kw in cases:
        _same(roofline.forward_costs(cfg, b, s, **kw),
              jax_counters.forward_costs(jcfg, b, s, **kw))


def test_count_params_allocates_nothing():
    """Jamba-1.5-Large whole is 398.56e9 parameters: the count comes from
    the meta device's shapes, with no storage behind any leaf."""
    state = build_model(get_config("jamba-1.5-large-398b")).init(
        0, device="meta")
    assert all(t.is_meta for t in leaves(state))
    assert roofline.count_params(get_config("jamba-1.5-large-398b")) == sum(
        float(t.numel()) for t in leaves(state))


# ---------------------------------------------------------------------------
# The three-term roofline
# ---------------------------------------------------------------------------

# One case per dominant term, and one with no FLOPs (a NaN ratio).
ROOFLINES = {
    "compute": (4.2e15, 3.1e11, 2.0e9),
    "memory": (1.0e12, 9.0e12, 2.0e9),
    "collective": (1.0e12, 3.1e11, 8.0e12),
    "no-flops": (0.0, 3.1e11, 2.0e9),
}


def _fields(case: str) -> dict:
    flops, nbytes, coll = ROOFLINES[case]
    return dict(arch="jamba-1.5-large-398b", shape="train_4k", mesh="4",
                chips=4, hlo_flops=flops, hlo_bytes=nbytes,
                collective_bytes=coll,
                collectives={"all-gather": coll * 0.75,
                             "collective-permute": coll * 0.25},
                collective_counts={"all-gather": 12,
                                   "collective-permute": 3},
                model_flops=3.3e15, bytes_per_device=7.5e10)


def test_roofline_holds_the_h100_constants():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (
        989e12, 3.35e12, 450e9) == (H100_SXM.peak_flops, H100_SXM.hbm_bw,
                                    H100_SXM.link_bw)
    assert analysis.PEAK_FLOPS != jax_analysis.PEAK_FLOPS


@pytest.mark.parametrize("case", sorted(ROOFLINES))
def test_roofline_matches_reference_with_constants_scaled_out(case,
                                                              monkeypatch):
    """Each term times its constant is the reference's term times its own;
    with the reference's constants set to the H100's, every property and
    ``to_dict`` agree."""
    got = roofline.Roofline(**_fields(case))
    want = jax_analysis.Roofline(**_fields(case))
    for term, port_c, ref_c in (
            ("t_compute", analysis.PEAK_FLOPS, jax_analysis.PEAK_FLOPS),
            ("t_memory", analysis.HBM_BW, jax_analysis.HBM_BW),
            ("t_collective", analysis.LINK_BW, jax_analysis.LINK_BW)):
        assert math.isclose(getattr(got, term) * port_c,
                            getattr(want, term) * ref_c, rel_tol=1e-15), term
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jax_analysis, name, getattr(analysis, name))
    got_d, want_d = got.to_dict(), want.to_dict()
    assert list(got_d) == list(want_d)
    ratio = got_d.pop("useful_flops_ratio")
    want_ratio = want_d.pop("useful_flops_ratio")
    assert got_d == want_d
    assert ratio == want_ratio or (math.isnan(ratio)
                                   and math.isnan(want_ratio))
    assert got.dominant == want.dominant == (
        case if case != "no-flops" else "memory")


def test_analyze_takes_the_ports_counts():
    """The step's costs from the counters, the collectives counted around
    the step, NaN peak memory off the card."""
    cfg, shape = get_config("tinyllama-1.1b"), SHAPES["train_4k"]
    costs = roofline.step_costs(cfg, shape, "train")
    x, w = (torch.from_numpy(a) for a in jax_reference.schedule_operands())
    with counting() as stats:
        SCHEDULE_FNS[Schedule.SERIAL](x, w)
    r = roofline.analyze(
        arch=cfg.name, shape=shape.name, mesh_name="tp4", chips=1,
        costs=costs, collectives=stats,
        model_flops=roofline.model_flops_for(cfg, shape, "train"))
    assert (r.hlo_flops, r.hlo_bytes) == (costs.flops, costs.bytes)
    assert r.collectives == {"all-gather": 8192.0}
    assert r.collective_counts == {"all-gather": 1}
    assert r.collective_bytes == 8192.0 and math.isnan(r.bytes_per_device)
    assert r.t_compute == costs.flops / 989e12
    assert r.dominant == "compute"


def test_counting_skips_the_backward():
    """The reduced TinyLlama's train step on uniform-fused-2d over 4
    ranks: with ``remat`` the backward reruns every period's forward, and
    its collectives are not counted; a forward without grad counts the
    same."""
    base = get_config("tinyllama-1.1b").reduced()
    cfg = dataclasses.replace(base, overlap=OverlapConfig(
        mode="uniform-fused-2d", backend="collective"))
    params = build_model(cfg).init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens}
    counts = []
    for model, grad in ((build_model(cfg), False), (build_model(cfg), True),
                        (build_model(dataclasses.replace(cfg, remat=True)),
                         True)):
        with tp_group(TPGroup(4, "cpu")), counting() as stats:
            if grad:
                loss_and_grads(model, params, batch)
            else:
                with torch.no_grad(), overlap_context(cfg.overlap):
                    model.loss(params, batch)
        counts.append((stats.bytes_by_kind, stats.count_by_kind))
    # 2 layers x 2 projections (up, gate) x 4 steps.
    assert counts[0][1] == {"all-gather": 16}
    assert counts[0] == counts[1] == counts[2]


# ---------------------------------------------------------------------------
# Against the reference's counts (last: they wait for the JAX subprocess)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_count_params_matches_reference(arch, counted):
    got = roofline.count_params(get_config(arch))
    assert got == counted[arch]
    assert roofline.param_bytes(get_config(arch)) == \
        jax_counters.param_bytes(jax_get_config(arch))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_step_costs_match_reference(arch, counted):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        for kind in KINDS:
            _same(roofline.step_costs(cfg, SHAPES[name], kind),
                  jax_counters.step_costs(jcfg, JAX_SHAPES[name], kind))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_active_params_and_model_flops_match_reference(arch, counted):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roofline.active_params(cfg) == jax_analysis.active_params(jcfg)
    for name in SHAPES:
        for kind in KINDS:
            assert roofline.model_flops_for(cfg, SHAPES[name], kind) == \
                jax_analysis.model_flops_for(jcfg, JAX_SHAPES[name], kind)


@pytest.mark.parametrize("name", [s.value for s in Schedule] + ["serial_a2a"])
def test_counted_collectives_match_parse_collectives(name,
                                                     reference_collectives):
    """Per-rank output bytes and calls by kind, as XLA compiled them (no
    collective combined or split at these shapes)."""
    if name == "serial_a2a":
        args = [torch.from_numpy(a) for a in jax_reference.moe_operands()]
        fn = serial_a2a_ffn
    else:
        args = [torch.from_numpy(a)
                for a in jax_reference.schedule_operands()]
        fn = SCHEDULE_FNS[Schedule(name)]
    with counting() as stats:
        fn(*args)
    want_bytes, want_counts = reference_collectives[name]
    assert stats.bytes_by_kind == want_bytes
    assert stats.count_by_kind == want_counts
