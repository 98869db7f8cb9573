"""The port's input specs (``repro_torch.launch.specs``) against the
reference's, for every arch in the registry at full width.

``input_specs`` at ``train_4k`` and ``decode_32k`` (its ``decode_specs``
for the latter) must give the reference's tree, leaf for leaf in shape and
dtype: the port builds its decode cache on the ``"meta"`` device, the
reference with ``jax.eval_shape``, so nothing is allocated on either side.
``concrete_batch`` must draw the reference's tokens, frames and patches
bit for bit.  Both sides run in this process.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import specs as jax_specs
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import specs
from repro_torch.models.model import build_model
from repro_torch.tree import leaves, treedef_str

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

ALL_ARCHS = sorted(ARCHS)


def _leaf(spec) -> tuple:
    """(shape, dtype name) of a port Spec or a ShapeDtypeStruct."""
    dtype = spec.dtype
    name = (str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).name)
    return tuple(spec.shape), name


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_reference(arch):
    import jax

    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in ("train_4k", "decode_32k"):
        got = specs.input_specs(cfg, SHAPES[name])
        want = jax_specs.input_specs(jcfg, JAX_SHAPES[name])
        assert treedef_str(got) == str(jax.tree.structure(want)), name
        assert [_leaf(s) for s in leaves(got)] == \
            [_leaf(s) for s in jax.tree.leaves(want)], name


def test_decode_specs_allocate_nothing():
    """Jamba's decode_32k cache at full width: 128 x 32768 keys and values
    in its attention layers, all on the meta device."""
    cfg = get_config("jamba-1.5-large-398b")
    model = build_model(cfg)
    got = specs.decode_specs(cfg, SHAPES["decode_32k"], model)
    assert _leaf(got["tokens"]) == ((128, 1), "int32")
    assert _leaf(got["pos"]) == ((), "int32")
    cache = model.init_cache(128, 32768, device="meta")
    assert all(t.is_meta for t in leaves(cache))
    assert [_leaf(s) for s in leaves(got["cache"])] == \
        [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
         for t in leaves(cache)]


def _bits(t) -> np.ndarray:
    """The raw bits of a torch tensor or a jax array (bf16 as int16)."""
    arr = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    if isinstance(arr, torch.Tensor):
        return arr.numpy()
    arr = np.asarray(arr)
    return arr.view(np.int16) if arr.dtype.itemsize == 2 else arr


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_concrete_batch_is_bit_equal_to_reference(arch):
    """Tokens, labels and the stub frontends' bf16 frames and patches,
    drawn from one seed in the specs' order."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = specs.concrete_batch(cfg, ShapeConfig("t", 64, 2, "train"), seed=3,
                               device="cpu")
    want = jax_specs.concrete_batch(jcfg, JaxShapeConfig("t", 64, 2, "train"),
                                    seed=3)
    assert list(got) == list(want)
    for name, t in got.items():
        assert _leaf(t) == _leaf(want[name]), name
        np.testing.assert_array_equal(_bits(t), _bits(want[name]),
                                      err_msg=name)
