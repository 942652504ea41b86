"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`; every test skips without a CUDA device (decided inside the
`cuda` fixture, never at import). The card machine has no JAX, and
tests/conftest.py imports it, so run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 kernels vs float32 references within 1e-4 (K1 in
every mode: exp2 with the scale folded into q, blockwise sums; its lse
within 1e-5 on rows that see a key, -inf on the others) and 1e-5
(K2, also with the decode pool and G > 1 groups, where the codes are
dequantized before their products on both sides); bf16 outputs
per element within two bf16 ulps of |reference| plus 1e-5 (both sides
round one float32 result to bf16), except K1's: its tensor cores take the
probabilities rounded to bf16 (as the TPU kernel does), so a bf16 K1
output is held to `bf16_output_limit` against the plain version on
float32 copies, two ulps plus 2^-8 (sum_j p_j |v_j|) / l plus 1e-5
(tests/test_torch_flash_prefill.py grounds it on the TPU kernel itself);
prompt mass and lse within 1e-5 in both dtypes. K3: float32
within 1e-4 of max|reference| (sums over K in another order); bf16 within
two ulps plus that same float32 limit, which an output near zero after
cancellation carries. K4: equal bit for bit (integer sums, one epilogue in
the same order).
"""

import dataclasses
import time

import pytest
import torch

import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu_torch.compression import (
    append_recent, compress_layer_kv, flush_recent, init_decode_pool,
    init_recent_cache)
from realtime_kv_cache_compression_tpu_torch.models import (
    beam_search, llama, speculative)
from realtime_kv_cache_compression_tpu_torch.models.quantized_params import (
    params_to, quantize_params, quantize_tensor, quantize_tensor_int4)
from realtime_kv_cache_compression_tpu_torch.ops.attention import (
    chunk_attention_with_prompt_mass, prefill_attention_with_prompt_mass,
    query_attention_mass)
from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention import (
    decode_attention_plain, fused_decode_attention, kernel_limits)
from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill import (
    POS_SENTINEL, bf16_limit_share, flash_chunk_attention_with_prompt_mass,
    flash_diagonal_pair_attention, flash_full_pair_attention,
    flash_pair_attention, flash_positioned_attention,
    flash_prefill_with_prompt_mass, pair_attention_plain,
    positioned_attention_plain)
from realtime_kv_cache_compression_tpu_torch.ops.cuda.int4_matmul import (
    int4_matmul, int4_matmul_plain, int4_matmul_tensor)
from realtime_kv_cache_compression_tpu_torch.ops.cuda.int8_matmul import (
    dynamic_int8_matmul, int8_matmul, int8_matmul_plain)
from realtime_kv_cache_compression_tpu_torch.ops.importance import (
    importance_scores)
from realtime_kv_cache_compression_tpu_torch.ops.quantization import (
    assign_precision)
from realtime_kv_cache_compression_tpu_torch.ops.sampling import (
    SamplingParams)
from realtime_kv_cache_compression_tpu_torch.ops.selection import (
    select_tokens)

pytestmark = pytest.mark.cuda

TOL_K1_F32 = 1e-4
# The float32 route's own accuracy (exp2 with the scale folded into q,
# sums in another order): 2.15e-6 measured at d=128, 300 keys.
TOL_K1_F32_EXACT = 4e-6
TOL_K2_F32 = 1e-5
TOL_MASS = 1e-5
TOL_LSE = 1e-5
TOL_K3_REL = 1e-4
BF16_ULPS, BF16_FLOOR = 2, 1e-5
# Idle seconds at each end of a profiler session that counts kernels: the
# profiler keeps only device events it places inside its window, and a
# session of a millisecond has come back without some of its kernels
# (chip_smoke.py, _profiled_kernels).
PROFILE_MARGIN_S = 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(out, ref, f32_tol, floor=BF16_FLOOR):
    """bf16: every element within BF16_ULPS ulps of |ref| plus `floor`;
    float32: within `f32_tol` absolute."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    if out.dtype == torch.bfloat16:
        mag = ref.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool((err <= BF16_ULPS * ulp + floor).all()), \
            float(err.max())
    else:
        assert float(err.max()) <= f32_tol


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _k1_refs(plain, q, k, v, *args, **kw):
    """`plain(q, k, v, ...)` on float32 copies, and its output with v
    replaced by |v| (the sum_j p_j |v_j| / l of `bf16_output_limit`)."""
    f = [t.float() for t in (q, k, v)]
    return plain(*f, *args, **kw), plain(f[0], f[1], f[2].abs(), *args,
                                         **kw)[0]


def _assert_k1_out(o, o_ref, o_abs):
    """A K1 output: bf16 within `bf16_output_limit`, float32 within
    TOL_K1_F32 of the plain version on float32 inputs."""
    if o.dtype == torch.bfloat16:
        share = bf16_limit_share(o, o_ref, o_abs)
        assert share <= 1.0, share
    else:
        assert float((o - o_ref).abs().max()) <= TOL_K1_F32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,plens", [
    (1, 512, 32, 4, 64, None),
    (2, 333, 8, 8, 16, (5, 40)),
    (2, 200, 8, 2, 32, (64, 1)),
    (1, 129, 4, 1, 128, None),
    (1, 300, 8, 8, 128, (100,)),  # Llama-2-7B heads: d=128, n_rep = 1
    (2, 1000, 32, 4, 64, (256, 300)),  # plen on a tile edge, straddling
    (1, 333, 8, 1, 256, (100,)),  # Gemma-2B heads: d=256, n_rep = 8
    (2, 200, 4, 4, 256, (64, 130)),  # Gemma-7B's d=256 at n_rep = 1
    (2, 300, 14, 2, 64, (100, 7)),   # Qwen2-0.5B heads: n_rep = 7
    (1, 257, 28, 4, 128, None),      # Qwen2-7B heads: n_rep = 7, d=128
])
def test_k1_matches_plain(cuda, dtype, b, s, hq, hkv, d, plens):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = _randn(gen, (b, s, hq, d), dtype, cuda)
    k = _randn(gen, (b, s, hkv, d), dtype, cuda)
    v = _randn(gen, (b, s, hkv, d), dtype, cuda)
    pl = None if plens is None else torch.tensor(plens, device=cuda)
    plen = 48 if plens is None else max(plens)
    before = flash_prefill_with_prompt_mass.launches
    o, pm = flash_prefill_with_prompt_mass(q, k, v, plen, prompt_lens=pl)
    torch.cuda.synchronize()
    assert flash_prefill_with_prompt_mass.launches == before + 1
    (o_ref, pm_ref), o_abs = _k1_refs(prefill_attention_with_prompt_mass,
                                      q, k, v, plen, prompt_lens=pl)
    assert o.dtype == dtype and pm.shape == (b, s)
    _assert_k1_out(o, o_ref, o_abs)
    assert float((pm - pm_ref).abs().max()) <= TOL_MASS


def _fused_qkv(gen, b, s, hq, hkv, d, dtype, device, pad=0):
    """q, k, v as column slices of one fused projection [B, S, (Hq + 2 Hkv)
    D + pad], as the main path's fused QKV hands them over."""
    qkv = _randn(gen, (b, s, (hq + 2 * hkv) * d + pad), dtype, device)
    q, k, v = qkv[..., :(hq + 2 * hkv) * d].split(
        [hq * d, hkv * d, hkv * d], dim=-1)
    return (q.unflatten(-1, (hq, d)), k.unflatten(-1, (hkv, d)),
            v.unflatten(-1, (hkv, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (2, 100, 8, 2, 32),
    (1, 333, 32, 4, 64),      # TinyLlama's heads
    (2, 150, 8, 8, 128),      # Llama-2-7B's heads
    (1, 77, 4, 2, 16),
    (1, 300, 8, 1, 256),      # Gemma-2B's heads
])
def test_k1_reads_strided_views(cuda, dtype, b, s, hq, hkv, d):
    """q/k/v as column slices of one fused projection (non-contiguous),
    in modes (a) and (b) (the bf16 route reads them through TMA maps)."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = _fused_qkv(gen, b, s, hq, hkv, d, dtype, cuda)
    assert not q.is_contiguous()
    o, pm = flash_prefill_with_prompt_mass(q, k, v, 20)
    (o_ref, pm_ref), o_abs = _k1_refs(prefill_attention_with_prompt_mass,
                                      q, k, v, 20)
    _assert_k1_out(o, o_ref, o_abs)
    assert float((pm - pm_ref).abs().max()) <= TOL_MASS
    c = s // 3
    o, pm = flash_chunk_attention_with_prompt_mass(q[:, -c:], k, v, s - c,
                                                   20)
    (o_ref, pm_ref), o_abs = _k1_refs(chunk_attention_with_prompt_mass,
                                      q[:, -c:], k, v, s - c, 20)
    _assert_k1_out(o, o_ref, o_abs)
    assert float((pm - pm_ref).abs().max()) <= TOL_MASS


@pytest.mark.parametrize("fault", ["base", "stride"])
def test_k1_refuses_views_tma_cannot_read(cuda, fault):
    """The bf16 route reads q/k/v by TMA: a base off 16 bytes or a row
    stride that is not a multiple of 8 elements raises, never falls
    back."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    if fault == "base":
        buf = _randn(gen, (1, 64 * 2 * 32 + 1), torch.bfloat16, cuda)
        q = buf[:, 1:].reshape(1, 64, 2, 32)
        k = v = q[:, :, :1]
    else:
        q, k, v = _fused_qkv(gen, 1, 64, 2, 1, 32, torch.bfloat16, cuda,
                             pad=3)
    before = flash_prefill_with_prompt_mass.launches
    with pytest.raises(ValueError, match="TMA"):
        flash_prefill_with_prompt_mass(q, k, v, 8)
    assert flash_prefill_with_prompt_mass.launches == before


@pytest.mark.parametrize("d", [64, 128, 256])
def test_k1_float32_takes_the_exact_scalar_route(cuda, d):
    """A float32 CUDA tensor runs the scalar-FMA kernel in float32 (no
    TF32 tensor cores, whose 10-bit significands would miss by about
    1e-3): within TOL_K1_F32_EXACT of the plain version in modes (a) and
    (d)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = _randn(gen, (2, 300, 8, d), torch.float32, cuda)
    k = _randn(gen, (2, 300, 2, d), torch.float32, cuda)
    v = _randn(gen, (2, 300, 2, d), torch.float32, cuda)
    o, pm = flash_prefill_with_prompt_mass(q, k, v, 100)
    o_ref, pm_ref = prefill_attention_with_prompt_mass(q, k, v, 100)
    assert float((o - o_ref).abs().max()) <= TOL_K1_F32_EXACT
    assert float((pm - pm_ref).abs().max()) <= TOL_K1_F32_EXACT
    pos = torch.randint(0, 500, (2, 300), generator=gen, device=cuda,
                        dtype=torch.int32)
    o, _, _ = flash_positioned_attention(q, k, v, pos, 200, 100)
    o_ref, _, _ = positioned_attention_plain(q, k, v, pos, 200, 100)
    assert float((o - o_ref).abs().max()) <= TOL_K1_F32_EXACT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,s,q_offset,hq,hkv,d,plens", [
    (2, 128, 512, 0, 32, 4, 64, (37, 100)),     # first chunk
    (2, 128, 512, 256, 32, 4, 64, (37, 100)),   # mid-buffer
    (2, 100, 512, 412, 8, 2, 32, None),         # last rows, ragged c
    (1, 96, 300, 150, 8, 8, 128, (40,)),        # d=128, n_rep = 1
    # Ragged c and S_k, q_offset off the 128-row grid, plen on a tile edge
    # (128) and straddling one (300), at every head_dim:
    (2, 200, 777, 333, 8, 2, 16, (128, 300)),
    (2, 200, 777, 333, 8, 2, 32, (128, 300)),
    (2, 200, 777, 333, 32, 4, 64, (128, 300)),
    (2, 200, 777, 333, 8, 8, 128, (128, 300)),
    (2, 200, 777, 333, 8, 1, 256, (128, 300)),
])
def test_k1_chunk_mode_matches_plain(cuda, dtype, b, c, s, q_offset, hq, hkv,
                                     d, plens):
    gen = torch.Generator(device=cuda).manual_seed(s + q_offset)
    q = _randn(gen, (b, c, hq, d), dtype, cuda)
    k = _randn(gen, (b, s, hkv, d), dtype, cuda)
    v = _randn(gen, (b, s, hkv, d), dtype, cuda)
    pl = None if plens is None else torch.tensor(plens, device=cuda)
    plen = 48 if plens is None else max(plens)
    before = flash_chunk_attention_with_prompt_mass.launches
    o, pm = flash_chunk_attention_with_prompt_mass(q, k, v, q_offset, plen,
                                                   prompt_lens=pl)
    torch.cuda.synchronize()
    assert flash_chunk_attention_with_prompt_mass.launches == before + 1
    # The plain version rounds probabilities to the value dtype before the
    # value product, as the reference does, so the kernel is held against
    # it on exact float32 copies of the same inputs.
    (o_ref, pm_ref), o_abs = _k1_refs(chunk_attention_with_prompt_mass,
                                      q, k, v, q_offset, plen,
                                      prompt_lens=pl)
    assert o.dtype == dtype and pm.shape == (b, c)
    _assert_k1_out(o, o_ref, o_abs)
    assert float((pm - pm_ref).abs().max()) <= TOL_MASS


def _assert_partial_close(part, ref, o_abs):
    """(o, lse, pm) of a kernel against its plain version on float32
    copies: o as `_assert_k1_out` holds K1, pm within TOL_MASS, lse within
    TOL_LSE on rows that see a key and -inf on both sides elsewhere."""
    (o, lse, pm), (o_ref, lse_ref, pm_ref) = part, ref
    assert lse.shape == pm.shape == lse_ref.shape
    _assert_k1_out(o, o_ref, o_abs)
    assert float((pm - pm_ref).abs().max()) <= TOL_MASS
    sees = torch.isfinite(lse_ref)
    assert torch.equal(sees, torch.isfinite(lse))
    assert bool((lse[~sees] == -torch.inf).all())
    assert float(o.float()[~sees.transpose(1, 2)].abs().sum()) == 0.0
    if sees.any():
        assert float((lse[sees] - lse_ref[sees]).abs().max()) <= TOL_LSE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,n,q_offset,hq,hkv,d,layout", [
    (2, 128, 700, 1024, 32, 4, 64, "invalid tiles"),  # ragged N
    (2, 100, 300, 200, 8, 8, 128, "future keys"),     # d=128, n_rep = 1
    (2, 64, 256, 0, 32, 4, 64, "all invalid"),        # the first chunk
    (1, 130, 96, 64, 16, 2, 32, "future keys"),
    (2, 70, 333, 500, 8, 2, 16, "future keys"),       # d=16, ragged N
    (2, 100, 300, 200, 8, 1, 256, "future keys"),     # Gemma-2B heads
    (2, 128, 700, 1024, 4, 4, 256, "invalid tiles"),  # d=256, n_rep = 1
])
def test_k1_positioned_mode_matches_plain(cuda, dtype, b, c, n, q_offset,
                                          hq, hkv, d, layout):
    """Mode (d) over pool slots: scattered positions, invalid slots at
    POS_SENTINEL in whole 128-key tiles and singly, keys later than some
    rows of the chunk, a row that sees no key, an all-invalid pool."""
    gen = torch.Generator(device=cuda).manual_seed(n + q_offset)
    q = _randn(gen, (b, c, hq, d), dtype, cuda)
    k = _randn(gen, (b, n, hkv, d), dtype, cuda)
    v = _randn(gen, (b, n, hkv, d), dtype, cuda)
    top = q_offset if layout == "invalid tiles" else q_offset + c
    pos = torch.randint(0, max(top, 1), (b, n), generator=gen, device=cuda,
                        dtype=torch.int32)
    if layout == "future keys":
        pos[0, :8] = q_offset + c - 1  # visible to the last row only
        pos[-1] = torch.clamp(pos[-1], min=q_offset + 1)  # row 0 sees none
    invalid = torch.rand((b, n), generator=gen, device=cuda) < 0.2
    invalid[:, 128:256] = True
    if layout == "all invalid":
        invalid[:] = True
    pos = torch.where(invalid, POS_SENTINEL, pos)
    prompt_len = max(q_offset // 2, 3)
    before = flash_positioned_attention.launches
    part = flash_positioned_attention(q, k, v, pos, q_offset, prompt_len)
    torch.cuda.synchronize()
    assert flash_positioned_attention.launches == before + 1
    assert part[0].dtype == dtype
    _assert_partial_close(part, *_k1_refs(positioned_attention_plain, q, k,
                                          v, pos, q_offset, prompt_len))
    if layout == "all invalid":
        assert not bool(torch.isfinite(part[1]).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,b,sq,sk,hq,hkv,d,plens", [
    (True, 2, 128, 128, 32, 4, 64, (37, 0)),     # the diagonal pair
    (True, 1, 96, 96, 8, 8, 128, (96,)),
    (False, 2, 128, 200, 32, 4, 64, (5, 200)),   # mode (c), ragged S_k
    (False, 1, 100, 77, 8, 8, 128, (0,)),
    (True, 2, 300, 300, 8, 2, 16, (128, 200)),   # plen on / across a tile
    (False, 2, 190, 260, 8, 2, 32, (256, 130)),
    (True, 2, 150, 150, 8, 1, 256, (64, 100)),   # d=256
    (False, 1, 100, 170, 4, 4, 256, (30,)),
])
def test_k1_pair_modes_match_plain(cuda, dtype, causal, b, sq, sk, hq, hkv,
                                   d, plens):
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = _randn(gen, (b, sq, hq, d), dtype, cuda)
    k = _randn(gen, (b, sk, hkv, d), dtype, cuda)
    v = _randn(gen, (b, sk, hkv, d), dtype, cuda)
    plen = torch.tensor(plens, dtype=torch.int32, device=cuda)
    counter = (flash_diagonal_pair_attention if causal
               else flash_full_pair_attention)
    before = counter.launches
    part = flash_pair_attention(q, k, v, plen, causal)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert part[0].dtype == dtype
    _assert_partial_close(part, *_k1_refs(pair_attention_plain, q, k, v,
                                          plen, causal))


def test_compressed_prefix_step_reads_no_device_value(cuda):
    """One compressed-prefix chunk step (K1 mode (d) and the diagonal pair,
    compression, the in-place pool update) under the sync debug mode: the
    host-int offset and chunk index read no device value."""
    mcfg = rt.tiny_test_model(num_layers=2, hidden_size=256, num_heads=8,
                              num_kv_heads=2, head_dim=32,
                              intermediate_size=512)
    ccfg = rt.CompressionConfig(num_layers=2)
    params = llama.init_params(0, mcfg, cuda)
    ids = torch.randint(0, mcfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    st = llama.prefill_chunked_compressed_init(2, 256, 64, mcfg, ccfg,
                                               device=cuda)
    st = llama.prefill_chunked_compressed_step(params, ids[:, :64], st, mcfg,
                                               ccfg, total_len=256)
    torch.cuda.synchronize()
    before = flash_positioned_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = llama.prefill_chunked_compressed_step(params, ids[:, 64:128], st,
                                                   mcfg, ccfg, total_len=256)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert st.offset == 128
    assert flash_positioned_attention.launches == before + 2


def test_compressed_prefix_kernel_path_tokens_equal_plain_path_f32(cuda):
    """Compressed-prefix chunked prefill (K1 mode (d) + diagonal pair) and
    fused decode over the chunk-packed tiers (K2) against the dense arm and
    the plain decode, on the card."""
    mcfg = rt.tiny_test_model(num_layers=2, hidden_size=256, num_heads=8,
                              num_kv_heads=2, head_dim=32,
                              intermediate_size=512)
    ccfg = rt.CompressionConfig(num_layers=2)
    params = llama.init_params(0, mcfg, cuda)
    ids = torch.randint(0, mcfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
    outs = []
    for kern in (True, False):
        logits, state, _ = llama.prefill_compressed_prefix_chunked(
            params, ids, mcfg, ccfg, chunk_size=64, max_decode_len=16,
            use_flash=kern)
        toks, _ = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                    12, mcfg, ccfg, use_fused=kern)
        outs.append(toks)
    assert torch.equal(outs[0], outs[1])


def _decode_state(cuda, dtype, ccfg, b, s, hq, hkv, d, ring, n_recent, seed):
    mcfg = rt.tiny_test_model(num_heads=hq, num_kv_heads=hkv, head_dim=d,
                              dtype=str(dtype).replace("torch.", ""))
    gen = torch.Generator(device=cuda).manual_seed(seed)
    k = _randn(gen, (b, s, hkv, d), dtype, cuda)
    v = _randn(gen, (b, s, hkv, d), dtype, cuda)
    mass = torch.rand((b, s), generator=gen, device=cuda)
    cache, _ = compress_layer_kv(k, v, mass, 0, ccfg, mcfg)
    recent = init_recent_cache(b, ring, mcfg, device=cuda)
    for i in range(n_recent):
        pos = torch.full((b, 1), s + i, dtype=torch.int32, device=cuda)
        append_recent(recent, _randn(gen, (b, 1, hkv, d), dtype, cuda),
                      _randn(gen, (b, 1, hkv, d), dtype, cuda), pos)
    q = _randn(gen, (b, 1, hq, d), dtype, cuda)
    q_pos = torch.full((b, 1), s + n_recent, dtype=torch.int32, device=cuda)
    q_pos[-1] -= 2  # the newest ring tokens lie in this row's future
    return q, cache, recent, q_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiers,shape", [
    ("8/4/2", dict(b=2, s=700, hq=32, hkv=4, d=64, ring=16, n_recent=5)),
    ("16/8/4", dict(b=1, s=1000, hq=32, hkv=4, d=64, ring=8, n_recent=8)),
    ("8/4/2 chunk 16", dict(b=2, s=300, hq=4, hkv=2, d=32, ring=4,
                            n_recent=0)),
    ("8/4/2", dict(b=1, s=260, hq=16, hkv=1, d=128, ring=4, n_recent=2)),
    ("8/4/2", dict(b=1, s=700, hq=8, hkv=8, d=128, ring=8, n_recent=3)),
    ("16/8/4", dict(b=2, s=90, hq=2, hkv=2, d=16, ring=4, n_recent=3)),
    ("8/4/2", dict(b=2, s=700, hq=8, hkv=1, d=256, ring=8, n_recent=5)),
    ("16/8/4", dict(b=1, s=300, hq=4, hkv=4, d=256, ring=4, n_recent=2)),
    ("8/4/2", dict(b=2, s=600, hq=14, hkv=2, d=64, ring=8, n_recent=3)),
    ("8/4/2", dict(b=1, s=700, hq=28, hkv=4, d=128, ring=8, n_recent=5)),
])
def test_k2_matches_plain(cuda, dtype, tiers, shape):
    ccfg = {"8/4/2": rt.CompressionConfig(num_layers=4),
            "16/8/4": rt.reference_anchor_config(num_layers=4),
            "8/4/2 chunk 16": rt.CompressionConfig(
                num_layers=4, pack_chunk_tokens=16)}[tiers]
    q, cache, recent, q_pos = _decode_state(cuda, dtype, ccfg, seed=7,
                                            **shape)
    before = fused_decode_attention.launches
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    torch.cuda.synchronize()
    assert fused_decode_attention.launches == before + 1
    ref = decode_attention_plain(q, cache, recent, q_pos, ccfg)
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close(out, ref, TOL_K2_F32)


def _pooled_state(cuda, dtype, ccfg, b, s, hq, hkv, d, ring, steps, seed):
    """A compressed layer, then `steps` decode appends with the ring
    flushed into the decode pool whenever it is full (as decode_step does),
    so the pool wraps once steps > ring * (blocks + 1)."""
    mcfg = rt.tiny_test_model(num_heads=hq, num_kv_heads=hkv, head_dim=d,
                              dtype=str(dtype).replace("torch.", ""))
    gen = torch.Generator(device=cuda).manual_seed(seed)
    k = _randn(gen, (b, s, hkv, d), dtype, cuda)
    v = _randn(gen, (b, s, hkv, d), dtype, cuda)
    mass = torch.rand((b, s), generator=gen, device=cuda)
    cache, _ = compress_layer_kv(k, v, mass, 0, ccfg, mcfg)
    recent = init_recent_cache(b, ring, mcfg, device=cuda)
    pool = init_decode_pool(b, ring, ccfg, mcfg, device=cuda)
    for i in range(steps):
        if i and i % ring == 0:
            flush_recent(recent, pool, ccfg, mcfg)
        pos = torch.full((b, 1), s + i, dtype=torch.int32, device=cuda)
        append_recent(recent, _randn(gen, (b, 1, hkv, d), dtype, cuda),
                      _randn(gen, (b, 1, hkv, d), dtype, cuda), pos)
    q = _randn(gen, (b, 1, hq, d), dtype, cuda)
    q_pos = torch.full((b, 1), s + steps, dtype=torch.int32, device=cuda)
    q_pos[-1] -= 2  # the newest ring tokens lie in this row's future
    return q, cache, recent, pool, q_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_bits,group_size,shape", [
    (4, 0, dict(b=2, s=700, hq=32, hkv=4, d=64)),
    (4, 32, dict(b=2, s=700, hq=32, hkv=4, d=64)),      # G = 2
    (16, 32, dict(b=2, s=700, hq=32, hkv=4, d=64)),
    (2, 8, dict(b=1, s=300, hq=8, hkv=2, d=64)),        # G = 8
    (4, 32, dict(b=1, s=500, hq=8, hkv=8, d=128)),      # G = 4, n_rep = 1
    (8, 8, dict(b=1, s=260, hq=16, hkv=1, d=128)),      # G = 16
    (16, 0, dict(b=2, s=90, hq=2, hkv=2, d=16)),
    (4, 0, dict(b=2, s=700, hq=8, hkv=1, d=256)),       # Gemma-2B, G = 1
    (4, 64, dict(b=2, s=700, hq=8, hkv=1, d=256)),      # G = 4
    (16, 64, dict(b=1, s=300, hq=4, hkv=4, d=256)),     # G = 4, n_rep = 1
    (8, 8, dict(b=1, s=260, hq=4, hkv=4, d=256)),       # G = 32
])
def test_k2_pool_and_groups_match_plain(cuda, dtype, pool_bits, group_size,
                                        shape):
    ccfg = rt.CompressionConfig(num_layers=4, quant_group_size=group_size,
                                decode_pool_blocks=2,
                                decode_pool_bits=pool_bits)
    q, cache, recent, pool, q_pos = _pooled_state(
        cuda, dtype, ccfg, ring=8, steps=30, seed=pool_bits, **shape)
    assert bool(pool.valid.all()) and int(recent.length[0]) == 6
    before = fused_decode_attention.launches
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg, pool=pool)
    torch.cuda.synchronize()
    assert fused_decode_attention.launches == before + 1
    ref = decode_attention_plain(q, cache, recent, q_pos, ccfg, pool=pool)
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close(out, ref, TOL_K2_F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (8, 2), (12, 4), (8, 1),
                                    (32, 2), (16, 1), (14, 2)])
@pytest.mark.parametrize("group_size", [0, 16])
def test_k2_matches_plain_at_every_n_rep_instance(cuda, dtype, hq, hkv,
                                                  group_size):
    """n_rep is a template parameter of the kernel (instances 1, 2, 4, 8,
    16; n_rep 3 takes the 4 instance with one head unread, Qwen2's n_rep
    7 the 8 instance), at G = 1 and
    G = 4 (16-channel groups at d = 64), tiers, decode pool and ring."""
    ccfg = rt.CompressionConfig(num_layers=4, quant_group_size=group_size,
                                decode_pool_blocks=2, decode_pool_bits=4)
    q, cache, recent, pool, q_pos = _pooled_state(
        cuda, dtype, ccfg, b=2, s=500, hq=hq, hkv=hkv, d=64, ring=8,
        steps=30, seed=hq + hkv)
    out = fused_decode_attention(q, cache, recent, q_pos, ccfg, pool=pool)
    ref = decode_attention_plain(q, cache, recent, q_pos, ccfg, pool=pool)
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close(out, ref, TOL_K2_F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_gives_the_same_bits_on_every_call(cuda, dtype):
    """K2 merges its splits in the launch through cached scratch (partials
    and tickets that every call leaves at zero), in split order:
    consecutive calls, and calls on two streams in turn, give identical
    bits."""
    ccfg = rt.CompressionConfig(num_layers=4)
    q, cache, recent, q_pos = _decode_state(
        cuda, dtype, ccfg, b=2, s=2000, hq=32, hkv=4, d=64, ring=16,
        n_recent=5, seed=3)
    first = fused_decode_attention(q, cache, recent, q_pos, ccfg)
    outs = [fused_decode_attention(q, cache, recent, q_pos, ccfg)
            for _ in range(3)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for i in range(4):
        stream = streams[i % 2]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(fused_decode_attention(q, cache, recent, q_pos,
                                               ccfg))
        torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert all(torch.equal(o.view(bits), first.view(bits)) for o in outs)
    _assert_close(first, decode_attention_plain(q, cache, recent, q_pos,
                                                ccfg), TOL_K2_F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_lse_mode_matches_plain_and_leaves_the_default_call(cuda, dtype):
    """K2's lse mode (a slot shard's partial: `return_lse=True`) over
    tiers, decode pool and ring, and over the tiers alone (no ring, as on
    every rank of a slot-sharded decode but the first): o in float32 and
    lse against the plain version's (lse within TOL_LSE of max(1, |lse|)
    on rows that see a key, -inf on a row that sees none; o, float32 in
    both dtypes, within TOL_K2_F32 of max(1, |o|), and in bf16 within
    the bf16 limit once rounded); o rounded to q's dtype equal bit for
    bit to the default call's output, which gives the same bits before
    and after lse calls; launches counted on `lse_launches`."""
    ccfg = rt.CompressionConfig(num_layers=4, decode_pool_blocks=2,
                                decode_pool_bits=4)
    q, cache, recent, pool, q_pos = _pooled_state(
        cuda, dtype, ccfg, b=2, s=700, hq=32, hkv=4, d=64, ring=8,
        steps=30, seed=11)
    q_pos[1] = -1  # row 1 sees no key
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    default = fused_decode_attention(q, cache, recent, q_pos, ccfg,
                                     pool=pool)
    launches = (fused_decode_attention.launches,
                fused_decode_attention.lse_launches)
    for ring, tail in ((recent, pool), (None, None)):
        o, lse = fused_decode_attention(q, cache, ring, q_pos, ccfg,
                                        pool=tail, return_lse=True)
        o_ref, lse_ref = decode_attention_plain(q, cache, ring, q_pos, ccfg,
                                                pool=tail, return_lse=True)
        assert o.dtype == lse.dtype == torch.float32
        assert o.shape == q.shape and lse.shape == (2, 32, 1)
        sees = torch.isfinite(lse_ref)
        assert torch.equal(sees, torch.isfinite(lse))
        assert bool((lse[1] == -torch.inf).all() and (o[1] == 0).all())
        tol = TOL_LSE * max(1.0, float(lse_ref[sees].abs().max()))
        assert float((lse[sees] - lse_ref[sees]).abs().max()) <= tol
        _assert_close(o, o_ref, TOL_K2_F32 * max(
            1.0, float(o_ref.abs().max())))
        if dtype == torch.bfloat16:
            _assert_close(o.to(dtype), o_ref, TOL_K2_F32)
        if ring is not None:
            assert torch.equal(o.to(dtype).view(bits), default.view(bits))
    again = fused_decode_attention(q, cache, recent, q_pos, ccfg, pool=pool)
    torch.cuda.synchronize()
    assert torch.equal(again.view(bits), default.view(bits))
    assert (fused_decode_attention.launches,
            fused_decode_attention.lse_launches) == (launches[0] + 1,
                                                     launches[1] + 2)


def test_k2_call_is_one_kernel_launch(cuda):
    """One `fused_decode_attention` call launches one kernel on the card
    (the splits merge in the same launch) and allocates only its output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ccfg = rt.CompressionConfig(num_layers=4, quant_group_size=32,
                                decode_pool_blocks=2, decode_pool_bits=4)
    q, cache, recent, pool, q_pos = _pooled_state(
        cuda, torch.bfloat16, ccfg, b=2, s=700, hq=32, hkv=4, d=64, ring=8,
        steps=30, seed=5)
    fused_decode_attention(q, cache, recent, q_pos, ccfg, pool=pool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(5):
            fused_decode_attention(q, cache, recent, q_pos, ccfg, pool=pool)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 5, kernels
    assert all("decode_attention_kernel" in name for name in kernels)


def test_k2_plans_by_the_kernels_limits(cuda):
    """The wrapper plans tiles and splits by the limits the built library
    reports (kTileTokens, kTileBytes, kGroupedScales, kMaxSplits), kept in
    the CUDA source alone."""
    lim = kernel_limits()
    assert (lim.tile_tokens, lim.tile_bytes, lim.grouped_scales,
            lim.max_splits) == (256, 16384, 1024, 64)


@pytest.mark.parametrize("width", [
    dict(hidden_size=512, num_heads=8, num_kv_heads=2, head_dim=64),
    dict(hidden_size=512, num_heads=4, num_kv_heads=4, head_dim=128)])
def test_decode_step_reads_no_device_value(cuda, width):
    """A decode step (rope, ring append, K2, MLP, logits) under the sync
    debug mode: the wrapper plans its splits on the host and reads no
    device value, so the host never waits for the card."""
    mcfg = rt.tiny_test_model(num_layers=2, intermediate_size=512, **width)
    ccfg = rt.CompressionConfig(num_layers=2)
    params = llama.fuse_params(llama.init_params(0, mcfg, cuda))
    ids = torch.randint(0, mcfg.vocab_size, (1, 300), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(4))
    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=8)
    tok = torch.argmax(logits, -1)
    llama.decode_step(params, tok, state, mcfg, ccfg)  # warm-up: scratch
    torch.cuda.synchronize()
    before = fused_decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, state = llama.decode_step(params, tok, state, mcfg, ccfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fused_decode_attention.launches == before + mcfg.num_layers
    assert bool(torch.isfinite(logits).all())


def test_pooled_chunked_kernel_path_tokens_equal_plain_path_f32(cuda):
    """Ragged chunked prefill (K1 mode b) + decode past a pool wrap with
    G = 2 (K2 with pool), kernels vs plain versions on the card."""
    mcfg = rt.tiny_test_model(num_layers=2, hidden_size=256, num_heads=8,
                              num_kv_heads=2, head_dim=32,
                              intermediate_size=512)
    ccfg = rt.CompressionConfig(num_layers=2, quant_group_size=16,
                                decode_pool_blocks=2, decode_pool_bits=4)
    params = llama.init_params(0, mcfg, cuda)
    ids = torch.randint(0, mcfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    lengths = torch.tensor([256, 190], device=cuda)
    outs = []
    for kern in (True, False):
        logits, state, _ = llama.prefill_compressed_chunked(
            params, ids, mcfg, ccfg, chunk_size=64, max_decode_len=8,
            lengths=lengths, use_flash=kern)
        toks, _ = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                    30, mcfg, ccfg, use_fused=kern)
        outs.append(toks)
    assert torch.equal(outs[0], outs[1])


def test_kernel_path_tokens_equal_plain_path_f32(cuda):
    mcfg = rt.tiny_test_model(num_layers=2, hidden_size=256, num_heads=8,
                              num_kv_heads=2, head_dim=32,
                              intermediate_size=512)
    ccfg = rt.CompressionConfig(num_layers=2)
    params = llama.init_params(0, mcfg, cuda)
    ids = torch.randint(0, mcfg.vocab_size, (2, 300), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    outs = [llama.generate(params, ids, mcfg, ccfg, max_new_tokens=12,
                           use_flash=kern, use_fused_decode=kern)[0]
            for kern in (True, False)]
    assert torch.equal(outs[0], outs[1])


def _small_model(cuda, num_layers=2):
    mcfg = rt.tiny_test_model(num_layers=num_layers, hidden_size=256,
                              num_heads=8, num_kv_heads=2, head_dim=32,
                              intermediate_size=512)
    return mcfg, llama.init_params(0, mcfg, cuda)


@pytest.mark.parametrize("source", ["query", "both"])
def test_query_guided_kernel_path_tokens_equal_plain_path_f32(cuda, source):
    """Query-guided scoring (window 32, even pool 6) on ragged rows: the
    kernel path (K1, K2) keeps the plain path's positions and greedy
    tokens, one-shot and chunked."""
    mcfg, params = _small_model(cuda)
    ccfg = rt.CompressionConfig(num_layers=2, importance_source=source,
                                query_window=32, query_mass_pool=6)
    ids = torch.randint(0, mcfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
    lengths = torch.tensor([256, 170], device=cuda)
    for chunked in (False, True):
        outs = []
        for kern in (True, False):
            if chunked:
                logits, state, _ = llama.prefill_compressed_chunked(
                    params, ids, mcfg, ccfg, chunk_size=64, max_decode_len=12,
                    lengths=lengths, use_flash=kern)
            else:
                logits, state, _ = llama.prefill_compressed(
                    params, ids, mcfg, ccfg, max_decode_len=12,
                    lengths=lengths, use_flash=kern)
            kept = [t.positions[t.valid].tolist() for c in state.caches
                    for t in c.tiers]
            toks, _ = llama.decode_loop(params, torch.argmax(logits, -1),
                                        state, 10, mcfg, ccfg, use_fused=kern)
            outs.append((kept, toks))
        assert outs[0][0] == outs[1][0]
        assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("ragged", [False, True])
def test_query_guided_scoring_reads_no_device_value(cuda, ragged):
    """The query mass (window 256 at S=4096, even pool 20), query-guided
    scores and selection make no host read of a device value."""
    ccfg = rt.CompressionConfig(num_layers=4, importance_source="both",
                                query_mass_pool=20)
    b, s, hq, hkv, d = 2, 4096, 8, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, s, hkv, d), generator=gen, device=cuda).bfloat16()
    mass = torch.rand((b, s), generator=gen, device=cuda)
    lengths = torch.tensor([s, 3000], device=cuda) if ragged else None
    token_valid = plens = None
    if ragged:
        token_valid = torch.arange(s, device=cuda)[None] < lengths[:, None]
        plens = llama._prompt_lens(lengths, ccfg, ccfg.prompt_length(s))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        qmass = query_attention_mass(q, k, ccfg.query_window_for(s),
                                     lengths=lengths,
                                     pool=ccfg.query_mass_pool)
        scores = importance_scores(mass, 1, s, ccfg.prompt_length(s), ccfg,
                                   lengths=lengths, prompt_lens=plens,
                                   query_mass=qmass)
        labels, _ = assign_precision(scores, ccfg)
        sel = select_tokens(scores, labels, 1, ccfg, token_valid=token_valid,
                            prompt_lens=plens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sel.kept_mask.shape == (b, s)


def test_chunked_q_tails_step_reads_no_device_value(cuda):
    """One chunked-prefill step that captures window query rows into
    `q_tails` (ragged rows: the positions come from the host offset and the
    device lengths) reads no device value."""
    mcfg, params = _small_model(cuda)
    ccfg = rt.CompressionConfig(num_layers=2, importance_source="query",
                                query_window=96)
    ids = torch.randint(0, mcfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(3))
    lengths = torch.tensor([256, 170], device=cuda)
    st = llama.prefill_chunked_init(2, 256, mcfg, ccfg, device=cuda)
    for off in (0, 64):
        st = llama.prefill_chunked_step(params, ids[:, off:off + 64], st,
                                        mcfg, ccfg, lengths=lengths)
    torch.cuda.synchronize()
    before = flash_chunk_attention_with_prompt_mass.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = llama.prefill_chunked_step(params, ids[:, 128:192], st, mcfg,
                                        ccfg, lengths=lengths)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert st.offset == 192
    assert flash_chunk_attention_with_prompt_mass.launches == before + 2
    assert bool(st.q_tails[0].abs().sum(dim=(2, 3)).gt(0).any())


def test_sampled_decode_step_reads_no_device_value(cuda):
    """A sampled decode step (penalties, top-k, top-p, min-p, Gumbel noise
    from a CUDA generator, counts and logprobs) reads no device value."""
    mcfg, params = _small_model(cuda)
    ccfg = rt.CompressionConfig(num_layers=2)
    params = llama.fuse_params(params)
    ids = torch.randint(0, mcfg.vocab_size, (1, 300), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(4))
    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=8)
    tok = torch.argmax(logits, -1)
    sampling = SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                              min_p=0.01, repetition_penalty=1.1)
    gen = torch.Generator(device=cuda).manual_seed(5)
    toks, state, counts = llama.decode_loop(  # warm-up: scratch, allocator
        params, tok, state, 1, mcfg, ccfg, generator=gen, sampling=sampling,
        return_counts=True)
    torch.cuda.synchronize()
    before = fused_decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, state, counts, lps = llama.decode_loop(
            params, toks[:, -1], state, 1, mcfg, ccfg, generator=gen,
            sampling=sampling, counts=counts, return_counts=True,
            return_logprobs=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fused_decode_attention.launches == before + mcfg.num_layers
    assert int(counts.sum()) == 3 and bool((lps <= 0).all())


def test_beam_step_reads_no_device_value(cuda):
    """A beam search of one step at B·W = 4 (the first expansion, one
    `decode_step` at 4 rows, the reindexing of rings and positions, EOS
    freezing and the final ranking) launches K2 once per layer and reads
    no device value."""
    mcfg, params = _small_model(cuda)
    params = llama.fuse_params(params)
    ccfg = rt.CompressionConfig(num_layers=2)
    ids = torch.randint(0, mcfg.vocab_size, (1, 300), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(6))
    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=4)
    eos = int(torch.argmax(logits, -1))

    def run():
        return beam_search._search(params, logits, state, mcfg, ccfg, 4, 2,
                                   1.0, eos, None)

    run()  # warm-up: scratch at 4 rows
    torch.cuda.synchronize()
    before = fused_decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        seqs, scores = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fused_decode_attention.launches == before + mcfg.num_layers
    assert seqs.shape == (1, 4, 2) and bool(torch.isfinite(scores).all())
    assert eos in seqs[0, :, 0].tolist()  # the frozen beam survives


def _pooled_decode_state(cuda, steps):
    """A fused 2-layer model and a B=2 state over an 8-token ring and a
    4-bit decode pool, after `steps` decode steps."""
    mcfg, params = _small_model(cuda)
    params = llama.fuse_params(params)
    ccfg = rt.CompressionConfig(num_layers=2, decode_pool_blocks=2,
                                decode_pool_bits=4)
    ids = torch.randint(0, mcfg.vocab_size, (2, 300), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(7))
    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=8)
    _, state = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                 steps, mcfg, ccfg)
    return mcfg, params, ccfg, state


def test_verify_and_commit_read_no_device_value(cuda):
    """`verify_forward` of a 5-token block, then `commit_block` with a
    host-known keep (5, 3) from ring fill 6: both rings fill at j = 1 and
    flush at j = 2, inside the commit. No device value is read."""
    mcfg, params, ccfg, state = _pooled_decode_state(cuda, 6)
    tokens = torch.randint(0, mcfg.vocab_size, (2, 5), device=cuda,
                           generator=torch.Generator(
                               device=cuda).manual_seed(8))
    keep = torch.tensor([5, 3], dtype=torch.int32, device=cuda)
    warm = llama.clone_decode_state(state)  # warm-up: allocator, scratch
    speculative.commit_block(
        warm, speculative.verify_forward(params, tokens, warm, mcfg, ccfg)[1],
        keep, mcfg, ccfg, host_keep=(5, 3))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, blocks = speculative.verify_forward(params, tokens, state,
                                                    mcfg, ccfg)
        state = speculative.commit_block(state, blocks, keep, mcfg, ccfg,
                                         host_keep=(5, 3))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.ring_fill == (3, 1)
    assert state.recents[1].length.tolist() == [3, 1]
    assert bool(state.pools[0].valid[:, :8].all())
    assert bool(torch.isfinite(logits).all())


def test_extend_prefill_leaves_its_input_state_unchanged(cuda):
    """A 12-token ragged suffix over an 8-token ring at fill 3 (rows flush
    inside the commit): the input state's tensors are byte-identical after
    the call, and the returned state has moved on."""
    mcfg, params, ccfg, state = _pooled_decode_state(cuda, 3)
    suffix = torch.randint(0, mcfg.vocab_size, (2, 12), device=cuda,
                           generator=torch.Generator(
                               device=cuda).manual_seed(9))
    before = [t.clone() for t in llama.decode_state_tensors(state)]
    last, new = speculative.extend_prefill(
        params, state, suffix, torch.tensor([12, 9], device=cuda), mcfg, ccfg)
    for a, b in zip(before, llama.decode_state_tensors(state), strict=True):
        assert torch.equal(a, b)
    assert state.ring_fill == (3, 3) and new.ring_fill == (7, 4)
    assert torch.equal(new.position, state.position + torch.tensor(
        [12, 9], dtype=state.position.dtype, device=cuda))
    assert last.shape == (2, mcfg.vocab_size)
    assert bool(torch.isfinite(last).all())


@pytest.mark.parametrize("ragged", [False, True])
def test_scoring_and_selection_read_no_device_value(cuda, ragged):
    """Compression runs once per layer between prefill launches: a host
    read of a device value (or a blocking host-to-device copy) there makes
    the host wait for the queued prefill in every layer."""
    ccfg = rt.CompressionConfig(num_layers=4)
    b, s = 2, 4096
    gen = torch.Generator(device=cuda).manual_seed(0)
    mass = torch.rand((b, s), generator=gen, device=cuda)
    lengths = torch.tensor([s, 3000], device=cuda) if ragged else None
    token_valid = plens = None
    if ragged:
        token_valid = torch.arange(s, device=cuda)[None] < lengths[:, None]
        plens = llama._prompt_lens(lengths, ccfg, ccfg.prompt_length(s))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scores = importance_scores(mass, 1, s, ccfg.prompt_length(s), ccfg,
                                   lengths=lengths, prompt_lens=plens)
        labels, _ = assign_precision(scores, ccfg)
        sel = select_tokens(scores, labels, 1, ccfg, token_valid=token_valid,
                            prompt_lens=plens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sel.kept_mask.shape == (b, s)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill_with_prompt_mass(q, q[:, :, :1], q[:, :, :1], 2)
    h = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_prefill_with_prompt_mass(h, h, h, 2)
    ccfg = rt.CompressionConfig(num_layers=4, quant_group_size=4)
    q, cache, recent, q_pos = _decode_state(
        cuda, torch.float32, ccfg, b=1, s=64, hq=2, hkv=2, d=16, ring=4,
        n_recent=1, seed=0)
    with pytest.raises(ValueError, match="scale groups"):
        fused_decode_attention(q, cache, recent, q_pos, ccfg)
    with pytest.raises(ValueError, match="outside"):
        flash_chunk_attention_with_prompt_mass(
            q[:, :, :, :16].expand(1, 8, 2, 16).contiguous(), recent.k,
            recent.v, 0, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,group_size", [
    (1, 4096, 4096, 128),    # decode GEMV, grouped
    (3, 256, 130, 64),       # ragged N (byte loads), small M
    (17, 384, 72, 64),       # tiled: ragged M, N below one tile
    (9, 100, 40, 128),       # single group, ragged K/2 edge
    (1, 100, 37, 128),       # single group, M=1, odd N
    (5, 11008, 256, 128),    # w_down's K: 43 groups per half
    (300, 4096, 640, 128),   # over several tiles (bf16: tensor cores)
])
def test_k3_matches_plain(cuda, dtype, m, k, n, group_size):
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    w = quantize_tensor_int4(_randn(gen, (k, n), torch.float32, cuda)
                             * k ** -0.5, group_size=group_size)
    x = _randn(gen, (m, k), dtype, cuda)
    before = int4_matmul.launches
    out = int4_matmul(x, w.q_packed, w.scale)
    torch.cuda.synchronize()
    assert int4_matmul.launches == before + 1
    ref = int4_matmul_plain(x, w.q_packed, w.scale)
    assert out.dtype == dtype and out.shape == (m, n)
    tol = TOL_K3_REL * float(ref.float().abs().max())
    _assert_close(out, ref, tol, floor=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,group_size,bf16_route", [
    (1, 1088, 4096, 32, "gemv"),           # 32-row groups, K/2 = 544
    (5, 1152, 1040, 64, "gemv"),           # ragged N past 8 column tiles
    (8, 11008, 4096, 128, "gemv"),         # M = 8, w_down's K
    (9, 4096, 4096, 128, "tensor_core"),   # M = 9: one ragged row tile
    (200, 1088, 1040, 32, "tensor_core"),  # K/2 = 544 (not 64 k), gs 32
    (200, 4096, 1040, 64, "tensor_core"),  # gs 64, ragged N
    (200, 1104, 528, 128, "tensor_core"),  # one group of 552 rows
    (130, 11008, 4096, 128, "tensor_core"),  # w_down: 43 groups per half
    (200, 1096, 528, 128, "tile"),         # K/2 % 8 != 0: x's high half
                                           # starts off TMA's 16 bytes
    (200, 512, 72, 64, "tile"),            # N % 16 != 0
])
def test_k3_routes_match_plain(cuda, dtype, m, k, n, group_size, bf16_route):
    """Every route at ragged M, N and K/2 and every group size the
    tensor-core route takes (16 / 32-row groups, 64-row multiples, one
    group), against the plain version; the route taken is counted: M <= 8
    the GEMV in both types, M > 8 the tensor cores in bf16 where the shape
    allows, else (and in float32) the scalar tile."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    w = quantize_tensor_int4(_randn(gen, (k, n), torch.float32, cuda)
                             * k ** -0.5, group_size=group_size)
    x = _randn(gen, (m, k), dtype, cuda)
    route = bf16_route if dtype == torch.bfloat16 or m <= 8 else "tile"
    before = dict(int4_matmul.route_launches)
    out = int4_matmul(x, w.q_packed, w.scale)
    torch.cuda.synchronize()
    assert {r: c - before[r] for r, c in
            int4_matmul.route_launches.items()} == {
                r: int(r == route) for r in before}
    ref = int4_matmul_plain(x, w.q_packed, w.scale)
    tol = TOL_K3_REL * float(ref.float().abs().max())
    _assert_close(out, ref, tol, floor=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 2])
def test_k3_expert_gemv_matches_plain(cuda, dtype, m):
    """The expert-indexed GEMV: one launch per call on its own route, the
    expert id read by the kernel from device ids (the last expert
    included), no host read (sync debug mode), against the plain version
    on that expert's codes and scales."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_expert_tensor_int4
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.int4_matmul \
        import int4_matmul_expert

    gen = torch.Generator(device=cuda).manual_seed(13 + m)
    e, k, n = 8, 1024, 2304
    w = quantize_expert_tensor_int4(
        _randn(gen, (e, k, n), torch.float32, cuda) * k ** -0.5)
    x = _randn(gen, (m, k), dtype, cuda)
    ids = torch.tensor([5, 7, 0, 3], dtype=torch.int32, device=cuda)
    int4_matmul_expert(x, w.q_packed, w.scale, ids, 0)  # warm-up: scratch
    torch.cuda.synchronize()
    before = dict(int4_matmul.route_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [int4_matmul_expert(x, w.q_packed, w.scale, ids, slot)
                for slot in range(4)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert {r: c - before[r] for r, c in
            int4_matmul.route_launches.items()} == {
                r: 4 * (r == "gemv_expert") for r in before}
    for ex, out in zip((5, 7, 0, 3), outs):
        ref = int4_matmul_plain(x, w.q_packed[ex], w.scale[ex])
        assert out.dtype == dtype and out.shape == (m, n)
        tol = TOL_K3_REL * float(ref.float().abs().max())
        _assert_close(out, ref, tol, floor=tol)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(3):
            int4_matmul_expert(x, w.q_packed, w.scale, ids, 1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    kernels = [ev.name for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    assert len(kernels) == 3 and all("int4_gemv" in k for k in kernels), \
        kernels


def test_moe_decode_step_reads_no_device_value(cuda):
    """A decode step of a 2-layer MoE model with int4 experts and int4
    attention matmuls under the sync debug mode: each layer's routed
    experts run K3's expert GEMV (k = 2 experts x 3 projections) and its
    unfused attention K3's GEMV (4), with no host read."""
    mcfg = rt.tiny_test_model(num_layers=2, hidden_size=512,
                              intermediate_size=1024, num_heads=8,
                              num_kv_heads=2, head_dim=64, num_experts=8,
                              num_experts_per_tok=2)
    ccfg = rt.CompressionConfig(num_layers=2)
    params = llama.fuse_params(quantize_params(
        llama.init_params(0, mcfg, cuda), bits=4))
    assert "wq" in params["layers"][0]  # MoE layers stay unfused
    ids = torch.randint(0, mcfg.vocab_size, (1, 300), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(4))
    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=8)
    tok = torch.argmax(logits, -1)
    llama.decode_step(params, tok, llama.clone_decode_state(state), mcfg,
                      ccfg)  # warm-up: scratch
    torch.cuda.synchronize()
    before = dict(int4_matmul.route_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, state = llama.decode_step(params, tok, state, mcfg, ccfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {r: c - before[r] for r, c in
            int4_matmul.route_launches.items()} == {
                "gemv": 4 * 2, "gemv_expert": 6 * 2, "tile": 0,
                "tensor_core": 0}
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_gemv_scratch_gives_the_same_bits_on_every_call(cuda, dtype):
    """The GEMV sums its K splits in the launch through cached scratch
    (partials and tickets that every call leaves at zero): consecutive
    calls, and calls on two streams in turn, give bit-identical results,
    and the same as a fresh process would (the plain version's limit)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    w = quantize_tensor_int4(_randn(gen, (4096, 12288), torch.float32, cuda)
                             * 4096 ** -0.5)
    x = _randn(gen, (1, 4096), dtype, cuda)
    first = int4_matmul(x, w.q_packed, w.scale)
    outs = [int4_matmul(x, w.q_packed, w.scale) for _ in range(3)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for i in range(4):
        stream = streams[i % 2]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(int4_matmul(x, w.q_packed, w.scale))
        torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert all(torch.equal(o.view(bits), first.view(bits)) for o in outs)
    ref = int4_matmul_plain(x, w.q_packed, w.scale)
    tol = TOL_K3_REL * float(ref.float().abs().max())
    _assert_close(first, ref, tol, floor=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (1, 4096, 4096), (2, 11008, 4096), (3, 300, 130), (17, 128, 72),
    (130, 11008, 200), (256, 4096, 512)])
def test_k4_matches_plain_bit_for_bit(cuda, dtype, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x_q = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                        dtype=torch.int8)
    xs = torch.rand((m,), generator=gen, device=cuda) + 0.01
    ws = torch.rand((n,), generator=gen, device=cuda) + 0.01
    before = int8_matmul.launches
    out = int8_matmul(x_q, w_q, xs, ws, out_dtype=dtype)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    ref = int8_matmul_plain(x_q, w_q, xs, ws, out_dtype=dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), ref.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,route", [
    (1, 4096, 12288, "gemv"),     # wqkv at decode
    (1, 11008, 4096, "gemv"),     # w_down's K
    (5, 300, 130, "gemv"),        # ragged K and N: byte loads
    (8, 4096, 22016, "gemv"),
    (9, 4096, 4096, "tc"),        # one ragged row tile
    (17, 4096, 528, "tc"),        # ragged N tile (528 = 2 x 256 + 16)
    (130, 11008, 4096, "tc"),     # w_down: 86 k-slabs, ragged M
    (4096, 4096, 4096, "tc"),     # prefill length
    (200, 1040, 272, "tc"),       # K = 8 slabs + 16: zero-filled slab tail
    (130, 1096, 528, "tile"),     # K % 16 != 0: TMA cannot read x
    (200, 512, 72, "tile"),       # N % 16 != 0
])
def test_k4_routes_equal_plain_bit_for_bit(cuda, dtype, m, k, n, route):
    """Every route, ragged M, N and K, against the plain version bit for
    bit in both output types (int32 sums are exact on every route); the
    route taken is counted."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x_q = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                        dtype=torch.int8)
    xs = torch.rand((m,), generator=gen, device=cuda) / 127 + 1e-4
    ws = torch.rand((n,), generator=gen, device=cuda) / 127 + 1e-4
    before = dict(int8_matmul.route_launches)
    out = int8_matmul(x_q, w_q, xs, ws, out_dtype=dtype)
    torch.cuda.synchronize()
    assert {r: c - before[r] for r, c in
            int8_matmul.route_launches.items()} == {
                r: int(r == route) for r in before}
    ref = int8_matmul_plain(x_q, w_q, xs, ws, out_dtype=dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), ref.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_gemv_scratch_gives_the_same_bits_on_every_call(cuda, dtype):
    """The GEMV sums its K splits in the launch through cached scratch
    (int32 partials and tickets that every call leaves at zero):
    consecutive calls, and calls on two streams in turn, give the plain
    version's bits."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    x_q = torch.randint(-127, 128, (2, 4096), generator=gen, device=cuda,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (4096, 12288), generator=gen,
                        device=cuda, dtype=torch.int8)
    xs = torch.rand((2,), generator=gen, device=cuda) / 127 + 1e-4
    ws = torch.rand((12288,), generator=gen, device=cuda) / 127 + 1e-4
    outs = [int8_matmul(x_q, w_q, xs, ws, out_dtype=dtype)
            for _ in range(3)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for i in range(4):
        stream = streams[i % 2]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(int8_matmul(x_q, w_q, xs, ws, out_dtype=dtype))
        torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    ref = int8_matmul_plain(x_q, w_q, xs, ws, out_dtype=dtype).view(bits)
    assert all(torch.equal(o.view(bits), ref) for o in outs)


def test_k3_k4_take_leading_dims(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = _randn(gen, (256, 96), torch.float32, cuda)
    x = _randn(gen, (2, 1, 256), torch.bfloat16, cuda)
    t4 = quantize_tensor_int4(w)
    y = int4_matmul_tensor(x, t4)
    assert y.shape == (2, 1, 96) and y.dtype == torch.bfloat16
    t8 = quantize_tensor(w, act_quant=True)
    y = dynamic_int8_matmul(x, t8.q, t8.scale)
    assert y.shape == (2, 1, 96) and y.dtype == torch.bfloat16


@pytest.mark.parametrize("lead,k,n", [((1, 1), 4096, 32000),
                                      ((2, 7), 256, 96)])
def test_int8_weight_only_bf16_matches_float32_route(cuda, lead, k, n):
    """The card's bf16 route (bf16 codes, float32 product) against the
    float32 route on the same card: equal products, sums in another order,
    one rounding to bf16 on each side; also the tied head's transposed
    codes."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    w = quantize_tensor(_randn(gen, (k, n), torch.float32, cuda)
                        * k ** -0.5)
    x = _randn(gen, (*lead, k), torch.bfloat16, cuda)
    ref = ((x.float() @ w.q.float()) * w.scale).to(torch.bfloat16)
    out = llama._int8_weight_only(x, w.q, w.scale)
    assert out.dtype == torch.bfloat16 and out.shape == (*lead, n)
    _assert_close(out, ref, None)
    q_t = w.q.T.contiguous().T  # [k, n] view of an [n, k] tensor
    _assert_close(llama._int8_weight_only(x, q_t, w.scale), ref, None)


@pytest.mark.parametrize("arm", [dict(bits=4, group_size=64),
                                 dict(bits=8, act_quant=True)])
def test_quantized_kernel_path_tokens_equal_plain_path_f32(cuda, arm):
    """Kernel path on the card vs the plain path on the CPU (where every
    wrapper takes its plain version), float32, 2 layers."""
    mcfg = rt.tiny_test_model(num_layers=2, hidden_size=256, num_heads=4,
                              num_kv_heads=4, head_dim=64,
                              intermediate_size=512)
    ccfg = rt.CompressionConfig(num_layers=2)
    params = llama.fuse_params(quantize_params(
        llama.init_params(0, mcfg, "cpu"), **arm))
    ids = torch.randint(0, mcfg.vocab_size, (2, 300),
                        generator=torch.Generator().manual_seed(1))
    before = (int4_matmul.launches, int8_matmul.launches)
    on_card = llama.generate(params_to(params, cuda), ids.to(cuda), mcfg,
                             ccfg, max_new_tokens=10)[0]
    launched = (int4_matmul.launches - before[0],
                int8_matmul.launches - before[1])
    assert launched[0 if arm["bits"] == 4 else 1] > 0
    plain = llama.generate(params, ids, mcfg, ccfg, max_new_tokens=10)[0]
    assert torch.equal(on_card.cpu(), plain)


def test_matmul_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w = quantize_tensor_int4(torch.randn((256, 64), device=cuda))
    x = torch.randn((2, 256), device=cuda)
    with pytest.raises(TypeError):
        int4_matmul(x.half(), w.q_packed, w.scale)
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul(torch.randn((256, 2), device=cuda).T, w.q_packed,
                    w.scale)
    with pytest.raises(ValueError, match="whole groups"):
        int4_matmul(x, w.q_packed, w.scale[:1].expand(3, -1).contiguous())
    q = torch.zeros((2, 256), dtype=torch.int8, device=cuda)
    wq = torch.zeros((256, 8), dtype=torch.int8, device=cuda)
    s2, s8 = torch.ones(2, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        int8_matmul(q.float(), wq, s2, s8)
    with pytest.raises(TypeError):
        int8_matmul(q, wq, s2, s8, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        int8_matmul(q, wq[:128], s2, s8)


def test_serving_engine_launches_k1_k2_and_matches_plain_engine(cuda):
    """A 2-layer float32 engine on the card serves 3 ragged requests
    through two slots: K1 once per layer and prefill, K2 once per layer
    and decode step, tokens equal to the engine on the plain versions."""
    from realtime_kv_cache_compression_tpu_torch.serving import ServingEngine

    mcfg = rt.tiny_test_model(num_layers=2, hidden_size=256, num_heads=4,
                              num_kv_heads=2, head_dim=64,
                              intermediate_size=512)
    ccfg = rt.CompressionConfig(num_layers=2)
    params = llama.init_params(0, mcfg, cuda)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, mcfg.vocab_size, (n,), generator=gen).tolist()
               for n in (256, 100, 190)]
    runs = {}
    for kernels in (True, False):
        eng = ServingEngine(params, mcfg, ccfg, num_slots=2, context_len=256,
                            max_new_tokens=10, decode_chunk=4,
                            use_flash=kernels, use_fused_decode=kernels)
        calls = eng.model_calls
        before = (flash_prefill_with_prompt_mass.launches,
                  fused_decode_attention.launches)
        rids = [eng.submit(p) for p in prompts]
        done = eng.run()
        launched = (flash_prefill_with_prompt_mass.launches - before[0],
                    fused_decode_attention.launches - before[1])
        runs[kernels] = [done[r].tokens for r in rids]
        if kernels:
            assert launched == (2 * calls["prefill"],
                                2 * 4 * calls["decode"])
            assert calls["prefill"] > 0 and calls["decode"] > 0
        else:
            assert launched == (0, 0)
    assert runs[True] == runs[False]
    assert all(len(t) == 10 for t in runs[True])


# chunked_prefix_quality's training at its documented sizes: float32, B=32,
# T=4096. With grouped heads only SDPA's math backend takes float32, and it
# keeps [B, H, S, S] a layer (8 GiB at these sizes; it ran out of the
# card's memory); with K and V expanded the memory-efficient backend
# takes the call.
TRAIN_PEAK_LIMIT_GIB = 16.0


def test_float32_gqa_training_step_fits_at_batch_32_and_4096_tokens(cuda):
    """One float32 training step of `chunked_prefix_quality`'s recall model
    (6 layers, 4 over 2 heads, d=32) at batch 32 and T=4096, the recalled
    span supervised as its trainer does: a finite loss, and a peak below
    TRAIN_PEAK_LIMIT_GIB (printed with -s)."""
    from realtime_kv_cache_compression_tpu_torch.experiments import (
        chunked_prefix_quality, quality_demo)
    from realtime_kv_cache_compression_tpu_torch.models import train

    payload, t, batch = 8, 4096, 32
    mcfg = chunked_prefix_quality.model_config(6, t + payload + 16)
    params = llama.init_params(0, mcfg, cuda)
    opt = train.make_optimizer(params, lr=1e-3, total_steps=10)
    gen = torch.Generator(device=cuda).manual_seed(42)
    ids, prompt_len, _ = quality_demo.make_batch(
        gen, batch, payload, t - payload - 1, mcfg.vocab_size, "recall")
    tpos = torch.arange(ids.shape[1] - 1, device=cuda)
    mask = ((tpos >= prompt_len - 1)
            & (tpos < prompt_len - 1 + payload)).expand(batch, -1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = float(train.train_step(params, opt, ids, mcfg, loss_mask=mask))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"float32 training step, B={batch} x {ids.shape[1]} tokens: loss "
          f"{loss:.4f}, peak {peak:.3f} GiB on "
          f"{torch.cuda.get_device_name(0)}")
    opt.release()
    assert loss == loss and abs(loss) < float("inf")
    assert peak < TRAIN_PEAK_LIMIT_GIB, peak


def test_float32_training_attention_backward_repeats_and_matches_sdpa(cuda):
    """The trainer's float32 attention on the card
    (`llama._EfficientCausalAttention`, K/V at the query heads): two
    backward passes give the same gradients bit for bit, and output and
    gradients agree with SDPA's math backend within 1e-5 (absolute, at
    values of magnitude 1)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((4, 1000, 8, 32), generator=gen, device=cuda)
               for _ in range(3))
    w = torch.randn((4, 1000, 8, 32), generator=gen, device=cuda)

    def run(attend):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = attend(*xs)
        (out * w).sum().backward()
        return [out.detach()] + [x.grad for x in xs]

    ours = [run(lambda *xs: llama._EfficientCausalAttention.apply(
        *xs, 32 ** -0.5)) for _ in range(2)]
    for a, b in zip(*ours):
        assert torch.equal(a, b)
    with sdpa_kernel(SDPBackend.MATH):
        ref = run(lambda *xs: torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in xs), is_causal=True,
            scale=32 ** -0.5).transpose(1, 2))
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours[0], ref):
        err = float((a - b).abs().max())
        assert err < 1e-5, (name, err)


def test_seq_parallel_prefill_on_two_ranks_runs_the_ring_kernels(cuda):
    """Two spawned ranks on this card (gloo, staged through the host) run
    a 2-layer float32 model's sequence-parallel prefill, replicated
    compression: rank 0 launches the diagonal pair once a layer and no
    mode (c), rank 1 both once a layer; logits within 1e-4 of the one-rank
    prefill's on the card, kept positions equal as sets."""
    import torch_ranks
    from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

    mcfg = rt.tiny_test_model(num_layers=2, hidden_size=256, num_heads=4,
                              num_kv_heads=2, head_dim=64,
                              intermediate_size=512)
    ccfg = rt.CompressionConfig(num_layers=2)
    res = run_ranks(torch_ranks.seq_parallel_on_card, 2,
                    args=(mcfg, ccfg, 512), timeout=300)
    params = llama.init_params(0, mcfg, cuda)
    ids = torch.randint(0, mcfg.vocab_size, (1, 512),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=8)
    for rank, r in enumerate(res):
        assert r["launches"] == (2, 2 * rank)
        assert float((r["logits"] - logits.cpu()).abs().max()) <= 1e-4
        for got, want in zip(r["caches"], state.caches):
            for tg, tw in zip(got.tiers, want.tiers):
                assert (set(tg.positions[0][tg.valid[0]].tolist())
                        == set(tw.positions[0][tw.valid[0]].cpu().tolist()))


def test_tensor_parallel_on_two_ranks_runs_k1_and_k2(cuda):
    """Two spawned ranks on this card (gloo, staged through the host), each
    with its half of a 2-layer float32 model of TinyLlama's widths (16 / 2
    heads a rank), run the tensor-parallel prefill and 8 greedy steps:
    each rank launches K1 once a layer and K2 once a layer and step, and
    its logits are within 1e-4 and its tokens equal to the one-rank run's
    on the card."""
    import torch_ranks
    from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

    mcfg = dataclasses.replace(rt.TINYLLAMA_1_1B, num_layers=2,
                               dtype="float32")
    ccfg = rt.CompressionConfig(num_layers=2)
    steps = 8
    res = run_ranks(torch_ranks.tensor_parallel_on_card, 2,
                    args=(mcfg, ccfg, 512, steps), timeout=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = llama.init_params(0, mcfg, cuda)
    ids = torch.randint(0, mcfg.vocab_size, (1, 512),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=steps + 4)
    toks, _ = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                steps, mcfg, ccfg)
    for r in res:
        assert r["launches"] == (2, 2 * steps)
        assert float((r["logits"] - logits.cpu()).abs().max()) <= 1e-4
        assert torch.equal(r["tokens"], toks.cpu())
