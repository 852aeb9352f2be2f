"""The JAX package's last `ops` names in the port, on the CPU:
`ops.image.letterbox_single` against the JAX function on the same seeded
canvas (within 1e-4 on the 0-255 scale, as `letterbox_batch`: both run
float32 matmuls that sum in other orders; scales and pads equal), and the
`CalculateMAP` alias of `MeanAveragePrecision`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.ops as jops
import fastvision_tpu.ops.image as jimage
from fastvision_tpu_torch import ops as tops


@pytest.mark.parametrize("hw,out_size,pad_value", [((48, 64), 64, 114.0), ((64, 30), 48, 0.0),
                                                   ((17, 23), 37, 114.0), ((64, 64), 64, 7.5)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_letterbox_single_matches_jax(hw, out_size, pad_value, dtype):
    rng = np.random.default_rng(out_size)
    canvas = np.full((64, 70, 3), 114, dtype)
    h, w = hw
    canvas[:h, :w] = rng.integers(0, 256, (h, w, 3)).astype(dtype)
    size_hw = np.asarray(hw, np.int32)
    want = [np.asarray(a) for a in jimage.letterbox_single(
        jnp.asarray(canvas), jnp.asarray(size_hw), out_size, pad_value)]
    got = [t.numpy() for t in tops.letterbox_single(
        torch.from_numpy(canvas), torch.from_numpy(size_hw), out_size, pad_value)]
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape == (out_size, out_size, 3)
    assert np.abs(got[0] - want[0]).max() <= 1e-4
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == want[2].dtype == np.int32
    bf16 = tops.letterbox_single(torch.from_numpy(canvas), size_hw, out_size, pad_value,
                                 dtype=torch.bfloat16)[0]
    assert bf16.dtype == torch.bfloat16


def test_calculate_map_is_mean_average_precision():
    assert jops.CalculateMAP is jops.MeanAveragePrecision
    assert tops.CalculateMAP is tops.MeanAveragePrecision
    assert "CalculateMAP" in tops.__all__ and "letterbox_single" in tops.__all__
