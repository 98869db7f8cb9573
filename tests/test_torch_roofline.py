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
"""

import pytest
import torch
import torch_jax_reference as jax_reference

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.roofline import analysis as jax_analysis
from repro.roofline import counters as jax_counters
from repro_torch import roofline
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.models.model import build_model
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
    return jax_reference.reference(tmp_path_factory, models=True)["counts"]


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
