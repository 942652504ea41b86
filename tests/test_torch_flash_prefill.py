"""Plain version of K1 (what `flash_prefill_with_prompt_mass` runs on CPU
tensors) vs the JAX Pallas kernel in interpret mode, and the bf16 limit
the CUDA kernel's tensor-core route is held to (`bf16_output_limit`),
grounded on the Pallas kernel's own bf16 rounding.

Inputs from a numpy seed, float32 (rounded to bf16 for the limit test).
Tolerance: output and prompt mass within 1e-5 absolute (float32 softmax
computed blockwise on one side and densely on the other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_kv_cache_compression_tpu.ops.pallas import (
    flash_prefill as jfp)
from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
    flash_prefill as tfp)

ATOL = 1e-5


def _qkv(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,hq,hkv,d,plen,ragged", [
    (2, 128, 4, 2, 16, 32, False),    # GQA, S a tile multiple
    (1, 200, 4, 4, 32, 40, False),    # MHA, S not a tile multiple
    (2, 96, 8, 1, 16, 24, True),      # 8:1 GQA, per-row prompt lengths
    (2, 130, 4, 2, 16, 26, True),     # ragged S and per-row lengths
    (1, 96, 2, 1, 256, 24, True),     # Gemma's head_dim
])
def test_plain_k1_matches_pallas(b, s, hq, hkv, d, plen, ragged):
    q, k, v = _qkv(s + hq, b, s, hq, hkv, d)
    plens = np.array([plen, plen // 3], np.int32)[:b] if ragged else None
    o_j, pm_j = jfp.flash_prefill_with_prompt_mass(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), plen,
        block_q=64, block_k=64, interpret=True,
        prompt_lens=None if plens is None else jnp.asarray(plens))
    o_t, pm_t = tfp.flash_prefill_with_prompt_mass(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), plen,
        prompt_lens=None if plens is None else torch.from_numpy(plens))
    assert o_t.shape == (b, s, hq, d) and pm_t.shape == (b, s)
    np.testing.assert_allclose(np.asarray(o_j), o_t.numpy(), atol=ATOL)
    np.testing.assert_allclose(np.asarray(pm_j), pm_t.numpy(), atol=ATOL)


def test_cpu_takes_plain_path_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 16, 2, 1, 16))
    before = tfp.flash_prefill_with_prompt_mass.launches
    o, pm = tfp.flash_prefill_with_prompt_mass(q, k, v, 4)
    o_ref, pm_ref = tfp.prefill_attention_with_prompt_mass(q, k, v, 4)
    assert torch.equal(o, o_ref) and torch.equal(pm, pm_ref)
    assert tfp.flash_prefill_with_prompt_mass.launches == before


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel path, whose checks raise for
    anything that is not a CUDA tensor, instead of silently running the
    plain version."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    k = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfp.flash_prefill_with_prompt_mass(q, k, k, 2)


# ---------------------------------------------------------------------------
# The bf16 limit of the CUDA kernel's tensor-core route, grounded here
# ---------------------------------------------------------------------------

def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def _emulate_tensor_cores(q, k, v, plen: int, bn: int = 128):
    """Mode (a) with the rounding of the CUDA kernel's bf16 route: float32
    scores of the bf16 inputs, scaled by sm_scale * log2(e) after the
    product; the online softmax over bn-key tiles; the unnormalised p
    rounded to bf16 for the value product only; l and the prompt mass in
    float32. Returns (out in bf16, prompt mass [B, S] head-averaged)."""
    b, s, hq, d = q.shape
    n_rep = hq // k.shape[2]
    kf, vf = (x.float().repeat_interleave(n_rep, dim=2) for x in (k, v))
    scale = 1.4426950408889634 / d ** 0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    pos = torch.arange(s)
    scores = torch.where(pos[None, :] <= pos[:, None], scores, -torch.inf)
    m = torch.full((b, hq, s), -torch.inf)
    l, pm = torch.zeros(b, hq, s), torch.zeros(b, hq, s)
    acc = torch.zeros(b, hq, s, d)
    for k0 in range(0, s, bn):
        st = scores[..., k0:k0 + bn]
        m_new = torch.maximum(m, st.amax(dim=-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(st - m_use[..., None])
        l = l * alpha + p.sum(dim=-1)
        pm = pm * alpha + p[..., :max(plen - k0, 0)].sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
            vf[:, k0:k0 + bn])
        m = m_new
    out = (acc / l[..., None]).transpose(1, 2).to(torch.bfloat16)
    return out, (pm / l).mean(dim=1)


@pytest.mark.parametrize("b,s,hq,hkv,d,plen", [
    (1, 256, 2, 1, 64, 100),    # plen straddles a 128-key tile
    (1, 192, 2, 2, 128, 128),   # Llama-2-7B's head_dim, plen on a tile edge
])
def test_bf16_limit_holds_the_tpu_kernels_rounding(b, s, hq, hkv, d, plen):
    """bf16 attention on tensor cores rounds the probabilities to bf16
    before the value product, as the JAX Pallas kernel does
    (`p.astype(v.dtype)`). Both that kernel (interpret mode, bf16 inputs)
    and a torch emulation of the CUDA kernel's rounding stay within
    `bf16_output_limit` of the plain version on float32 copies, and both
    break the old limit of two output ulps plus 1e-5, which is the derived
    limit without its probability-rounding term. The emulation's prompt
    mass keeps 1e-5 (float32 p, scores scaled after the product)."""
    q32, k32, v32 = (_bf16(x).float() for x in _qkv(d + s, b, s, hq, hkv, d))
    ref, pm_ref = tfp.prefill_attention_with_prompt_mass(q32, k32, v32, plen)
    ref_abs = tfp.prefill_attention_with_prompt_mass(q32, k32, v32.abs(),
                                                     plen)[0]
    o_jax, _ = jfp.flash_prefill_with_prompt_mass(
        *(jnp.asarray(x.numpy(), jnp.bfloat16) for x in (q32, k32, v32)),
        plen, block_q=64, block_k=64, interpret=True)
    o_jax = torch.from_numpy(np.array(o_jax.astype(jnp.float32)))
    o_emu, pm_emu = _emulate_tensor_cores(*(x.to(torch.bfloat16)
                                            for x in (q32, k32, v32)), plen)
    for o in (o_jax, o_emu):
        assert tfp.bf16_limit_share(o, ref, ref_abs) <= 1.0
        assert tfp.bf16_limit_share(o, ref, torch.zeros_like(ref)) > 1.0
    assert float((pm_emu - pm_ref).abs().max()) <= ATOL


@pytest.mark.parametrize("mode", ["b", "c", "d", "pair"])
def test_plain_k1_modes_at_head_dim_256(mode):
    """Gemma's head_dim (256) in modes (b), (c), (d) and the diagonal pair
    (mode (a) is a case of test_plain_k1_matches_pallas): the plain
    versions the port's wrappers run on CPU tensors against the Pallas
    kernel in interpret mode. (b): a 32-row chunk at q_offset 48 over 96 keys; (c) and the
    diagonal pair: a 64-row block with a local prompt length of 20; (d):
    keys at shuffled positions, a quarter invalid. Same tolerance (1e-5)
    for o, prompt mass and, on rows that see a key, lse."""
    b, hq, hkv, d, s, plen = 1, 2, 1, 256, 96, 24
    q, k, v = _qkv(d + len(mode), b, s, hq, hkv, d)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    blocks = dict(block_q=32, block_k=64, interpret=True)
    if mode == "b":
        outs_j = jfp.flash_chunk_attention_with_prompt_mass(
            qj[:, 48:80], kj, vj, 48, plen, **blocks)
        outs_t = tfp.flash_chunk_attention_with_prompt_mass(
            qt[:, 48:80], kt, vt, 48, plen)
    elif mode in ("c", "pair"):
        causal = mode == "pair"
        outs_j = jfp.flash_pair_attention(qj[:, :64], kj[:, :64], vj[:, :64],
                                          jnp.int32(20), causal, **blocks)
        outs_t = tfp.flash_pair_attention(qt[:, :64], kt[:, :64], vt[:, :64],
                                          20, causal)
    else:
        rng = np.random.default_rng(5)
        pos = rng.permutation(s).astype(np.int32)
        pos[rng.random(s) < 0.25] = tfp.POS_SENTINEL
        outs_j = jfp.flash_positioned_attention(
            qj[:, 64:], kj, vj, jnp.asarray(pos[None]), 64, plen, **blocks)
        outs_t = tfp.flash_positioned_attention(
            qt[:, 64:], kt, vt, torch.from_numpy(pos[None]), 64, plen)
    for a, t in zip(outs_j, outs_t, strict=True):
        a, t = np.asarray(a), t.numpy()
        assert a.shape == t.shape
        seen = np.isfinite(a)
        np.testing.assert_array_equal(seen, np.isfinite(t))
        np.testing.assert_allclose(a[seen], t[seen], atol=ATOL)
