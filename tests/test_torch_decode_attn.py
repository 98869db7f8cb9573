"""The port's decode attention over a time-sharded cache
(``repro_torch.parallel.decode_attn``) against the reference's
``shard_map`` flash-decode, which runs in the shared JAX subprocess
(``tests/torch_jax_reference.py``, entry ``decode_attn``) on a mesh of 4
host devices on the ``model`` axis, with GQA 8/2, fp32.

The model-level decode through it is held against the plain decode in
``tests/test_torch_parallel.py``.
"""

import numpy as np
import pytest
import torch
import torch_jax_reference as ref_driver

from repro_torch.models.layers import cache_attention
from repro_torch.parallel import decode_attn
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
