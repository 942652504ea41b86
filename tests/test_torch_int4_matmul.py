"""K3's plain version and its wrappers vs the JAX package (CPU).

Same float32 inputs (numpy seeds) and the same JAX-quantized weights go
through the JAX kernel in interpret mode, through JAX's `llama._matmul`
(its off-TPU grouped form) and through the port's `int4_matmul`, which
takes `int4_matmul_plain` on CPU tensors. Tolerance 2e-4 absolute and
relative, as the JAX package's own kernel test uses: the sums run in
another order (per-group partials, then scales) than the kernel's blocks.
Shapes are those of the JAX package's tests: M=1, padding, several
k-blocks, and the single-group fallback.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.models.quantized_params import (
    quantize_tensor_int4)
from realtime_kv_cache_compression_tpu.ops.pallas.int4_matmul import (
    int4_matmul as j_int4_matmul)
from realtime_kv_cache_compression_tpu_torch.models import (
    quantized_params as tq)
from realtime_kv_cache_compression_tpu_torch.ops.cuda import int4_matmul as t4

TOL = 2e-4


def _int4(w, group_size):
    jt = quantize_tensor_int4(jnp.asarray(w), group_size=group_size)
    tt = tq.Int4Tensor(q_packed=torch.from_numpy(np.array(jt.q_packed)),
                       scale=torch.from_numpy(np.array(jt.scale)),
                       in_dim=jt.in_dim)
    return jt, tt


@pytest.mark.parametrize("m,k,n,group_size,blocks", [
    (8, 256, 128, 64, {}),                                 # grouped
    (1, 256, 128, 128, {}),                                # decode, M=1
    (4, 100, 40, 128, {}),                                 # single group
    (3, 384, 72, 64, dict(block_k2=128, block_n=128)),     # padding
    (5, 1024, 96, 128, dict(block_k2=128)),                # many k-blocks
])
def test_plain_matches_jax_kernel_and_matmul(m, k, n, group_size, blocks):
    rng = np.random.default_rng(k + n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jt, tt = _int4(w, group_size)
    want_k = np.asarray(j_int4_matmul(jnp.asarray(x), jt.q_packed, jt.scale,
                                      jt.group_size, interpret=True,
                                      **blocks))
    want_m = np.asarray(jl._matmul(jnp.asarray(x), jt))
    before = t4.int4_matmul.launches
    got = t4.int4_matmul(torch.from_numpy(x), tt.q_packed, tt.scale)
    assert t4.int4_matmul.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want_k, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_m, rtol=TOL, atol=TOL)


def test_tensor_form_takes_leading_dims():
    # The 2-D form is held to JAX above; here the leading dims fold and
    # unfold around it (no JAX call: one compile fewer).
    rng = np.random.default_rng(7)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    tt = tq.quantize_tensor_int4(torch.from_numpy(w), group_size=128)
    got = t4.int4_matmul_tensor(torch.from_numpy(x), tt)
    assert got.shape == (2, 3, 64)
    flat = t4.int4_matmul(torch.from_numpy(x.reshape(6, 256)), tt.q_packed,
                          tt.scale)
    np.testing.assert_array_equal(got.numpy().reshape(6, 64), flat.numpy())
    np.testing.assert_allclose(
        got.numpy(), x @ tt.dequantize(torch.float32).numpy(), rtol=TOL,
        atol=TOL)


def test_group_layout_is_checked():
    # The group size comes from the operands: K/2 packed rows, n_g scales.
    assert t4._groups(2048, 1) == (2048, 0)
    assert t4._groups(2048, 32) == (128, 16)
    assert t4._groups(5504, 86) == (128, 43)  # w_down, K = 11008
    with pytest.raises(ValueError, match="whole groups"):
        t4._groups(100, 6)  # 3 groups do not split 100 rows
    with pytest.raises(ValueError, match="whole groups"):
        t4._groups(256, 3)  # odd: the halves cannot share the rows


@pytest.mark.parametrize("m,k,n,group_size,dtype,route", [
    (1, 4096, 12288, 128, torch.bfloat16, "gemv"),
    (8, 11008, 4096, 128, torch.float32, "gemv"),
    (9, 4096, 4096, 128, torch.bfloat16, "tensor_core"),
    (4096, 1088, 1040, 32, torch.bfloat16, "tensor_core"),  # 32-row groups
    (200, 1104, 528, 128, torch.bfloat16, "tensor_core"),   # one group
    (200, 1096, 528, 128, torch.bfloat16, "tile"),  # K/2 % 8: off 16 bytes
    (200, 512, 72, 64, torch.bfloat16, "tile"),     # N % 16 != 0
    (4096, 4096, 4096, 128, torch.float32, "tile"),  # float32: exact route
])
def test_route_by_shape_and_type(m, k, n, group_size, dtype, route):
    """The wrapper's dispatch by shape and type (what a CUDA tensor would
    launch), and the GEMV's splits: one wave of at most GEMV_BLOCKS blocks
    where GEMV_MAX_ROWS packed rows per block allow it, each block at
    most GEMV_MAX_ROWS rows."""
    w = tq.quantize_tensor_int4(torch.zeros((k, n)), group_size=group_size)
    gs, _ = t4._groups(k // 2, w.scale.shape[0])
    x = torch.zeros((m, k), dtype=dtype)
    assert t4._route(x, w.q_packed, gs) == route
    split = t4.gemv_split(m, n, k // 2)
    assert -(-(k // 2) // split) <= t4.GEMV_MAX_ROWS
    tiles = -(-n // t4.gemv_block_cols(m))
    assert (tiles * split <= t4.GEMV_BLOCKS
            or split == -(-(k // 2) // t4.GEMV_MAX_ROWS))
