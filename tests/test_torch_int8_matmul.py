"""K4's plain version and its wrappers vs the JAX package (CPU).

`quantize_activations` must give the same int8 codes and float32 scales,
and `int8_matmul_plain` must equal the JAX kernel in interpret mode and
`int8_matmul_xla` bit for bit in float32: the integer sum is exact in both
and the epilogue rounds in the same order (float32(acc) * x_scale *
w_scale). On CPU tensors the wrappers take the plain version and launch
nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_kv_cache_compression_tpu.ops.pallas import int8_matmul as j8
from realtime_kv_cache_compression_tpu_torch.ops.cuda import _build
from realtime_kv_cache_compression_tpu_torch.ops.cuda import int8_matmul as t8


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    xs = (rng.random(m) + 0.01).astype(np.float32)
    ws = (rng.random(n) + 0.01).astype(np.float32)
    return x_q, w_q, xs, ws


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (24, 128, 256),
                                   (5, 300, 200)])
def test_plain_equals_jax_kernel_and_xla_bitwise(m, k, n):
    ops = _operands(m, k, n, seed=m)
    want_k = np.asarray(j8.int8_matmul(*map(jnp.asarray, ops),
                                       out_dtype=jnp.float32, block_k=128,
                                       interpret=True))
    want_x = np.asarray(j8.int8_matmul_xla(*map(jnp.asarray, ops),
                                           out_dtype=jnp.float32))
    before = t8.int8_matmul.launches
    got = t8.int8_matmul(*map(torch.from_numpy, ops),
                         out_dtype=torch.float32).numpy()
    assert t8.int8_matmul.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want_k.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want_x.view(np.uint32))


def test_large_k_sum_converts_with_rounding():
    """|acc| past 2^24 (K = 11008 at full codes) rounds to float32 the way
    XLA's convert does."""
    k = 11008
    x_q = np.full((2, k), 127, np.int8)
    w_q = np.full((k, 3), 127, np.int8)
    w_q[0, 1] = 126  # an odd sum: not representable in float32
    ones = np.ones(2, np.float32), np.ones(3, np.float32)
    want = np.asarray(j8.int8_matmul_xla(jnp.asarray(x_q), jnp.asarray(w_q),
                                         *map(jnp.asarray, ones),
                                         out_dtype=jnp.float32))
    got = t8.int8_matmul_plain(torch.from_numpy(x_q), torch.from_numpy(w_q),
                               *map(torch.from_numpy, ones),
                               out_dtype=torch.float32).numpy()
    assert abs(127 * 127 * k) > 2 ** 24
    np.testing.assert_array_equal(got, want)


def test_quantize_activations_bit_exact():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 3, 64)) * rng.random((2, 3, 1)) * 4
         ).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    jq, js = j8.quantize_activations(jnp.asarray(x))
    tq, ts = t8.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js).view(np.uint32),
                                  ts.numpy().view(np.uint32))


def test_dynamic_int8_matmul_equals_jax_bitwise():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    from realtime_kv_cache_compression_tpu.models.quantized_params import (
        quantize_tensor)
    qt = quantize_tensor(jnp.asarray(w), axis=1)
    want = np.asarray(j8.dynamic_int8_matmul(jnp.asarray(x), qt.q, qt.scale,
                                             use_kernel=False))
    got = t8.dynamic_int8_matmul(torch.from_numpy(x),
                                 torch.from_numpy(np.array(qt.q)),
                                 torch.from_numpy(np.array(qt.scale)))
    assert got.shape == (2, 5, 96) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_split_k_fills_the_card_and_keeps_whole_ranges():
    # Llama-2-7B decode shapes: (K, N) of wqkv, wo, w_gateup, w_down, lm_head.
    for k, n in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                 (4096, 32000)):
        for m in (1, 8):
            split = t8.gemv_split(m, n, k)
            tiles = -(-n // t8.gemv_block_cols(m))
            assert -(-k // split) <= t8.GEMV_MAX_ROWS
            assert (tiles * split <= t8.GEMV_BLOCKS
                    or split == -(-k // t8.GEMV_MAX_ROWS))
            assert (tiles * split > t8.GEMV_BLOCKS // 2
                    or split == k // t8.GEMV_MIN_ROWS)
    assert t8.gemv_split(1, 8, 16) == 1


@pytest.mark.parametrize("m,k,n,route", [
    (1, 4096, 12288, "gemv"),
    (8, 11008, 4096, "gemv"),
    (9, 4096, 4096, "tc"),        # one ragged row tile
    (4096, 11008, 22016, "tc"),   # w_gateup at prefill length
    (200, 1104, 528, "tc"),
    (200, 1096, 528, "tile"),     # K % 16 != 0: TMA cannot read x's rows
    (200, 512, 72, "tile"),       # N % 16 != 0: no 16-byte W rows
])
def test_route_by_shape_and_type(m, k, n, route):
    """The wrapper's dispatch (what a CUDA tensor would launch): by shape
    alone, the same route for bf16 and float32 outputs, since the int32
    sums are exact on every route."""
    x_q = torch.zeros((m, k), dtype=torch.int8)
    w_q = torch.zeros((k, n), dtype=torch.int8)
    assert t8._route(x_q, w_q) == route
