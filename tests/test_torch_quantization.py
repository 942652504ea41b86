"""PyTorch port's quantization vs the JAX package's (CPU).

Same inputs from a numpy seed go through both. Packed codes must be
byte-identical (2/4/8 bits, chunked and unchunked, and raw 16-bit values);
scales and zero points agree within 1e-6 (both are float32 results of the
same operation order); dequantized values within 1e-5. The JAX side runs
eagerly here, op by op, as the port does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.ops import quantization as jq
from realtime_kv_cache_compression_tpu_torch.ops import quantization as tq

ATOL_PARAMS = 1e-6
ATOL_VALUES = 1e-5


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("group_size,clip", [(16, 0.0), (4, 0.0),
                                             (16, 0.1), (8, 0.25)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_params_and_codes(bits, group_size, clip):
    x = _x(bits + group_size, (2, 40, 3, 16))
    x[0, 0, 0] = 1.5  # a constant group: the degenerate scale=1, zp=0 case
    js, jz = jq.quant_params(jnp.asarray(x), bits, group_size, clip_frac=clip)
    ts, tz = tq.quant_params(torch.from_numpy(x), bits, group_size,
                             clip_frac=clip)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), atol=ATOL_PARAMS)
    np.testing.assert_allclose(np.asarray(jz), tz.numpy(), atol=ATOL_PARAMS)
    # Codes from the same (JAX) params: identical.
    codes_j = jq.quantize(jnp.asarray(x), js, jz, bits)
    js_t, jz_t = torch.from_numpy(np.array(js)), torch.from_numpy(
        np.array(jz))
    codes_t = tq.quantize(torch.from_numpy(x), js_t, jz_t, bits)
    _eq(codes_j, codes_t)
    deq_j = jq.dequantize(codes_j.astype(jnp.float32), js, jz)
    deq_t = tq.dequantize(codes_t.float(), js_t, jz_t)
    np.testing.assert_allclose(np.asarray(deq_j), deq_t.numpy(),
                               atol=ATOL_VALUES)


@pytest.mark.parametrize("n,chunk", [(64, None), (62, None), (7, None),
                                     (64, 16), (96, 32), (128, 128)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_byte_identical(bits, n, chunk):
    codes = np.random.default_rng(n * bits).integers(
        0, 2 ** bits, (2, n, 3, 16)).astype(np.uint8)
    pj = jq.pack_codes(jnp.asarray(codes), bits, axis=-3, chunk=chunk)
    pt = tq.pack_codes(torch.from_numpy(codes), bits, axis=-3, chunk=chunk)
    assert pt.dtype == torch.uint8
    _eq(pj, pt)
    uj = jq.unpack_codes(pj, bits, n, axis=-3, chunk=chunk)
    ut = tq.unpack_codes(pt, bits, n, axis=-3, chunk=chunk)
    _eq(uj, ut)
    np.testing.assert_array_equal(ut.numpy(), codes)


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_quantize_tier_byte_identical(bits, chunk):
    x = _x(bits, (2, 64, 2, 16))
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
        sj, scj, zj = jq.quantize_tier(jnp.asarray(x), bits, 16,
                                       store_dtype=dtype_j, chunk=chunk)
        st, sct, zt = tq.quantize_tier(torch.from_numpy(x), bits, 16,
                                       store_dtype=dtype_t, chunk=chunk)
        if bits == 16:  # raw values in the store dtype, bit for bit
            assert st.dtype == dtype_t
            np.testing.assert_array_equal(
                np.asarray(sj.astype(jnp.float32)), st.float().numpy())
        else:
            assert st.dtype == torch.uint8
            _eq(sj, st)
        np.testing.assert_allclose(np.asarray(scj), sct.numpy(),
                                   atol=ATOL_PARAMS)
        np.testing.assert_allclose(np.asarray(zj), zt.numpy(),
                                   atol=ATOL_PARAMS)
        dj = jq.dequantize_tier(sj, scj, zj, bits, chunk=chunk)
        dt = tq.dequantize_tier(st, sct, zt, bits, chunk=chunk)
        np.testing.assert_allclose(np.asarray(dj), dt.numpy(),
                                   atol=ATOL_VALUES)


def test_assign_precision_costs_and_memory_report():
    scores = np.random.default_rng(3).random((2, 50)).astype(np.float32)
    valid = np.random.default_rng(4).random((2, 50)) > 0.3
    for kw in ({}, dict(high_precision_bits=16, medium_precision_bits=8,
                        low_precision_bits=4, theta_h=0.6, theta_m=0.2)):
        cj, ct = rj.CompressionConfig(**kw), rt.CompressionConfig(**kw)
        lj, stj = jq.assign_precision(jnp.asarray(scores), cj)
        lt, stt = tq.assign_precision(torch.from_numpy(scores), ct)
        _eq(lj, lt)
        for key in stj:
            np.testing.assert_allclose(np.asarray(stj[key]),
                                       stt[key].numpy(), atol=1e-7)
        np.testing.assert_array_equal(np.asarray(jq.token_costs(lj, cj)),
                                      tq.token_costs(lt, ct).numpy())
        for gs in (0, 8):
            mj = jq.memory_report(lj, jnp.asarray(valid), cj, 64,
                                  original_tokens=100, group_size=gs)
            mt = tq.memory_report(lt, torch.from_numpy(valid), ct, 64,
                                  original_tokens=100, group_size=gs)
            for key in mj:
                np.testing.assert_allclose(np.asarray(mj[key]),
                                           mt[key].numpy(), rtol=1e-6)
