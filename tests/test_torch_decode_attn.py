"""The port's decode attention over a time-sharded cache
(``repro_torch.parallel.decode_attn``) against the reference's
``shard_map`` flash-decode, which runs in the shared JAX subprocess
(``tests/torch_jax_reference.py``, entry ``decode_attn``) on a mesh of 4
host devices on the ``model`` axis, with GQA 8/2, fp32.

On a rank of a group of processes (a ``RankGroup``) the guard reads the
full length from the rank's slice, ``cache_positions`` sizes that slice
by the reference's ``cache_leaf_spec`` and ``Model.init_cache`` records
it; the per-rank body itself runs in ``tests/test_torch_group.py``.
The model-level decode through it is held against the plain decode in
``tests/test_torch_parallel.py``.
"""

import numpy as np
import pytest
import torch
import torch_jax_reference as ref_driver

from repro_torch.models.layers import cache_attention
from repro_torch.parallel import decode_attn
from repro_torch.parallel.group import RankGroup
from repro_torch.parallel.sharding import TPGroup, tp_group

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

CFG = ref_driver.DECODE_ATTN


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    ref_driver.start(tmp_path_factory)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ref_driver.reference(tmp_path_factory)["decode_attn"]


def _operands():
    return [torch.from_numpy(a.copy())
            for a in ref_driver.decode_attn_operands()]


@pytest.mark.parametrize("pos", ref_driver.DECODE_ATTN_POS)
def test_matches_reference_shard_map(pos, reference):
    """pos in the first, a middle and the last of the 4 time shards."""
    q, k_new, v_new, k_c, v_c = _operands()
    with tp_group(TPGroup(CFG["g"], "cpu")):
        assert decode_attn.applicable(k_c, None)
        out, k2, v2 = decode_attn.shard_map_attn_decode(
            q, k_new, v_new, k_c, v_c, pos)
    assert k2 is k_c and v2 is v_c  # updated in place
    want_out, want_k, want_v = reference[pos]
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(k2.numpy(), want_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v2.numpy(), want_v, rtol=1e-5, atol=1e-5)
    # And the unsharded cache attention on the same update.
    q, k_new, v_new, k_c, v_c = _operands()
    k_c[:, pos], v_c[:, pos] = k_new[:, 0], v_new[:, 0]
    plain = cache_attention(q, k_c, v_c, valid_len=pos + 1)
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group,s,window,want", [
    (4, 1024, None, True),
    (4, 4096, None, True),
    (None, 1024, None, False),   # no TP group
    (1, 1024, None, False),      # a group of one
    (4, 1024, 256, False),       # a sliding window
    (4, 512, None, False),       # S < 1024
    (3, 1024, None, False),      # S not a multiple of the group
])
def test_applicable(group, s, window, want):
    k_cache = torch.zeros(2, s, 2, 8)
    with tp_group(TPGroup(group, "cpu") if group else None):
        assert decode_attn.applicable(k_cache, window) is want


def _rank(size: int):
    """A stand-in for rank 0 of a group of ``size`` processes: all that
    ``applicable`` and ``cache_positions`` read of a ``RankGroup``."""
    group = RankGroup.__new__(RankGroup)
    group.rank, group.size = 0, size
    return group


@pytest.mark.parametrize("slice_len,window,time_slice,want", [
    (256, None, True, True),      # a quarter of 1024
    (1024, None, True, True),     # a quarter of 4096
    (256, 256, True, False),      # a sliding window
    (512, None, False, False),    # whole: the guard refused 512
    (2048, None, False, False),   # whole, whatever its length
])
def test_applicable_on_a_rank_reads_the_full_length(slice_len, window,
                                                    time_slice, want):
    with tp_group(_rank(4)):
        assert decode_attn.applicable(torch.zeros(2, slice_len, 2, 8),
                                      window, time_slice) is want


@pytest.mark.parametrize("size,shape,want", [
    (4, (22, 4, 2048, 4, 64), 512),     # the rank's time slice
    (4, (22, 4, 1024, 4, 64), 256),
    (4, (27, 4, 2048, 512), 512),       # MLA's latent
    (4, (27, 4, 2048, 1, 64), 512),     # and its rope key
    (1, (22, 4, 2048, 4, 64), 2048),    # a group of one
    (4, (22, 4, 512, 4, 64), 512),      # under 1024: whole
    (4, (22, 4, 1026, 4, 64), 1026),    # not a multiple of 4: whole
])
def test_cache_positions_on_a_rank(size, shape, want):
    """The reference's rule, whatever the decode attention: the time axis
    cut where it is 1024 or more and the group divides it."""
    with tp_group(_rank(size)):
        assert decode_attn.cache_positions(shape) == want


def test_cache_positions_raise_where_the_rule_cuts_another_dim():
    """A latent of 4096 outgrows a cache of 1024: the rule cuts the
    latent, which no per-rank decode reads."""
    with tp_group(_rank(4)), pytest.raises(NotImplementedError,
                                           match="time axis"):
        decode_attn.cache_positions((2, 1, 1024, 4096))


def test_cache_positions_off_a_rank():
    with tp_group(TPGroup(4, "cpu")):
        assert decode_attn.cache_positions((2, 1, 2048, 4, 8)) == 2048
    assert decode_attn.cache_positions((2, 1, 512, 4, 8)) == 512


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
@pytest.mark.parametrize("cache,sliced", [(2048, True), (512, False)])
def test_init_cache_records_the_time_slice(cache, sliced, mode):
    """``Model.init_cache`` on a rank, in either decode attention: the
    slice and its record where the reference's rule cuts the cache, the
    whole cache and no record where not."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.models.model import build_model

    cfg = get_config("tinyllama-1.1b").reduced()
    cfg = dataclasses.replace(cfg, overlap=OverlapConfig(decode_attn=mode))
    group = _rank(4)
    group.rank = 2
    with tp_group(group):
        caches = build_model(cfg).init_cache(1, cache, device="meta")
    for c in caches:
        assert c["k"].shape[-3] == (cache // 4 if sliced else cache)
        assert ("time_slice" in c) is sliced
        if sliced:
            assert c["time_slice"].shape == c["k"].shape[:1]
