"""K1's tuning surface on the port against the JAX package: the tile
(`block_q`, `block_k`) on every wrapper, JAX's three mode (a) variants
(`fold_gqa`, `exp_bf16`, `stats_via_mxu`) and the `kernel_autotune` CLI.

CPU cases: seeded numpy inputs through the JAX function in interpret mode
(as `tests/test_flash.py` runs it) and through the port's wrapper, which
checks the tile and runs its plain version on CPU tensors. Tolerances:
2e-5 absolute in float32 (a blockwise softmax against a dense one), and
JAX's 3e-2 where exp_bf16 is on; the port's plain exp_bf16 meets
TOL_EXP_BF16_JAX against JAX's (it truncates exp2 to bf16 as the card's
instruction does and keeps the float32 route's 16-key running maximum,
where JAX's interpret mode rounds to nearest over 128-key blocks). JAX is
imported inside the CPU cases, so that the card machine, which has no
JAX, imports this file.

Card cases (marked `cuda`, skipped without a CUDA device): every built
tile of every mode and every variant against its plain version, and the
default call's bits before and after the variants ran:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_autotune.py
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from realtime_kv_cache_compression_tpu_torch.ops.attention import (
    prefill_attention_with_prompt_mass)
from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
    flash_prefill as tfp)
from realtime_kv_cache_compression_tpu_torch.parallel.ring_attention import (
    ring_prefill_attention)

ATOL = 2e-5
TOL_EXP_BF16 = 3e-2        # JAX's own limit for exp_bf16 (tests/test_flash.py)
TOL_EXP_BF16_JAX = 1.5e-2  # the port's plain exp_bf16 against JAX: 7.2e-3
                            # to 1.14e-2 measured over seeds 0-11
TOL_MASS = 1e-5
TOL_LSE = 1e-5
TOL_K1_F32 = 1e-4
# The card's exp_bf16 against the plain version with the same flag and
# running maximum (`exp_block_keys`), on float32 copies of the inputs: the
# output within `bf16_output_limit` in either dtype (its probabilities are
# bf16), the prompt mass within this, absolute (chip_smoke.py's
# TOL_MASS_EXP_BF16; scripts/torch_ex2_bf16_probe.py measures both at
# these shapes, and the default kernel against the same plain version).
TOL_MASS_EXP_BF16 = 1e-4


def _np(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


def test_block_arguments_on_every_wrapper_match_jax():
    """Non-default tiles on all five wrappers and on the one-rank ring, in
    float32 with ragged prompt lengths, against JAX at the same block_q /
    block_k (ragged S pads on JAX's side, where its wrappers pad)."""
    import jax.numpy as jnp
    from realtime_kv_cache_compression_tpu.ops.pallas import (
        flash_prefill as jfp)

    b, hq, hkv, d = 2, 4, 2, 64
    t = torch.from_numpy
    # Mode (a): S=192 over 64 x 128 tiles, ragged per-row prompt lengths.
    q, k, v = _np(1, (b, 192, hq, d), (b, 192, hkv, d), (b, 192, hkv, d))
    plens = np.array([50, 17], np.int32)
    o_j, pm_j = jfp.flash_prefill_with_prompt_mass(
        *map(jnp.asarray, (q, k, v)), 64, block_q=64, block_k=128,
        interpret=True, prompt_lens=jnp.asarray(plens))
    o_t, pm_t = tfp.flash_prefill_with_prompt_mass(
        t(q), t(k), t(v), 64, prompt_lens=t(plens), block_q=64, block_k=128)
    _close(o_t, o_j, ATOL)
    _close(pm_t, pm_j, ATOL)
    # The ring over one rank is the diagonal pair over the whole sequence:
    # mode (a)'s function, at its own tile.
    o_r, pm_r = ring_prefill_attention(t(q), t(k), t(v), 64, None,
                                       prompt_lens=t(plens), block_q=128,
                                       block_k=64)
    _close(o_r, o_j, ATOL)
    _close(pm_r, pm_j, ATOL)

    # Mode (b): a chunk of 96 rows at q_offset 64 over a 256-row buffer.
    qc, kb, vb = _np(2, (b, 96, hq, d), (b, 256, hkv, d), (b, 256, hkv, d))
    o_j, pm_j = jfp.flash_chunk_attention_with_prompt_mass(
        *map(jnp.asarray, (qc, kb, vb)), jnp.asarray(64), 100,
        prompt_lens=jnp.asarray(plens + 40), block_q=64, block_k=64,
        interpret=True)
    o_t, pm_t = tfp.flash_chunk_attention_with_prompt_mass(
        t(qc), t(kb), t(vb), 64, 100, prompt_lens=t(plens + 40), block_q=64,
        block_k=64)
    _close(o_t, o_j, ATOL)
    _close(pm_t, pm_j, ATOL)

    # The pairs (JAX wants block-divisible shards: 128 rows and keys).
    qp, kp, vp = _np(3, (b, 128, hq, d), (b, 128, hkv, d), (b, 128, hkv, d))
    plen_local = np.array([40, 0], np.int32)
    for causal, (bq, bk) in ((True, (64, 128)), (False, (128, 64))):
        part_j = jfp.flash_pair_attention(
            *map(jnp.asarray, (qp, kp, vp, plen_local)), causal=causal,
            block_q=bq, block_k=bk, interpret=True)
        part_t = tfp.flash_pair_attention(
            *map(t, (qp, kp, vp, plen_local)), causal=causal, block_q=bq,
            block_k=bk)
        for got, want in zip(part_t, part_j):
            _close(got, want, ATOL)

    # Mode (d) over 160 unordered slots (some invalid), and the compressed
    # prefix over those pools plus the chunk's own keys.
    rng = np.random.default_rng(4)
    n, c, off = 160, 128, 300
    qd, kd, vd = _np(5, (b, c, hq, d), (b, n, hkv, d), (b, n, hkv, d))
    pos = rng.permutation(np.arange(off))[:n].reshape(1, n).repeat(b, 0)
    valid = rng.random((b, n)) > 0.2
    kpos = np.where(valid, pos, tfp.POS_SENTINEL).astype(np.int32)
    part_j = jfp.flash_positioned_attention(
        *map(jnp.asarray, (qd, kd, vd, kpos)), jnp.asarray(off), 120,
        block_q=64, block_k=128, interpret=True)
    part_t = tfp.flash_positioned_attention(
        *map(t, (qd, kd, vd, kpos)), off, 120, block_q=64, block_k=128)
    for got, want in zip(part_t, part_j):
        _close(got, want, ATOL)
    kc, vc = _np(6, (b, c, hkv, d), (b, c, hkv, d))
    o_j, pm_j = jfp.flash_compressed_prefix_attention(
        *map(jnp.asarray, (qd, kd, vd, pos.astype(np.int32), valid, kc, vc)),
        jnp.asarray(off), 350, block_q=64, block_k=128, pool_block_q=64,
        pool_block_k=64, interpret=True)
    o_t, pm_t = tfp.flash_compressed_prefix_attention(
        *map(t, (qd, kd, vd, pos.astype(np.int32), valid, kc, vc)), off, 350,
        block_q=64, block_k=128, pool_block_q=64, pool_block_k=64)
    _close(o_t, o_j, ATOL)
    _close(pm_t, pm_j, ATOL)


def test_refusals_name_the_rule():
    """A size that is not a power of two raises as JAX's wrapper does; a
    power of two that names no built tile raises with the tiles built for
    that mode and head_dim; so do a variant off the default tile and a
    fold whose group outgrows a tile's rows. Clamping follows JAX's."""
    import jax.numpy as jnp
    from realtime_kv_cache_compression_tpu.ops.pallas import (
        flash_prefill as jfp)

    q, k, v = (torch.from_numpy(x) for x in _np(
        7, (1, 96, 4, 64), (1, 96, 2, 64), (1, 96, 2, 64)))
    with pytest.raises(ValueError, match="powers of two"):
        jfp.flash_prefill_with_prompt_mass(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)), 8, block_q=96,
            interpret=True)
    with pytest.raises(ValueError, match="powers of two"):
        tfp.flash_prefill_with_prompt_mass(q, k, v, 8, block_q=96)
    with pytest.raises(ValueError, match="powers of two"):
        ring_prefill_attention(q, k, v, 8, None, block_k=0)
    built = r"built: \[\(64, 64\), \(64, 128\), \(128, 64\), \(128, 128\)\]"
    with pytest.raises(ValueError, match="no 32 x 128 tile.*" + built):
        tfp.flash_prefill_with_prompt_mass(q, k, v, 8, block_q=32)
    # Mode (d)'s 128 x 128 spills, so it is not built.
    with pytest.raises(ValueError, match=r"no 128 x 128 tile .* positioned "
                                         r"at head_dim 64"):
        tfp.flash_positioned_attention(q, k, v, torch.zeros(
            (1, 96), dtype=torch.int32), 0, 8, block_q=128, block_k=128)
    with pytest.raises(ValueError, match=r"positioned at head_dim 32; "
                                         r"built: \[\(128, 64\)\]"):
        tfp.flash_positioned_attention(
            q[..., :32], k[..., :32], v[..., :32],
            torch.zeros((1, 96), dtype=torch.int32), 0, 8, block_k=128)
    with pytest.raises(ValueError, match="default tile"):
        tfp.flash_prefill_with_prompt_mass(q, k, v, 8, block_k=64,
                                           exp_bf16=True)
    q_wide = torch.zeros((1, 8, 256, 256))
    with pytest.raises(ValueError, match="fold_gqa"):
        tfp.flash_prefill_with_prompt_mass(q_wide, q_wide[:, :, :1],
                                           q_wide[:, :, :1], 8,
                                           fold_gqa=True)
    # Clamped as JAX clamps: 512 past a 96-row sequence names 128.
    assert tfp.resolve_tile(tfp._CAUSAL, 64, 96, 96, 512, 512) == (128, 128)
    assert tfp.resolve_tile(tfp._CAUSAL, 64, 50, 50, 512, None) == (64, 128)
    assert tfp.resolve_tile(tfp._POSITIONED, 256, 10, 10) == (64, 64)


@pytest.mark.parametrize("fold,expb,stats", [
    (True, True, False),     # tests/test_flash.py::test_flash_variant_flags
    (None, False, True),     # ::test_flash_stats_via_mxu, exp_bf16 off
    (None, True, True),      # and on
])
def test_variants_match_jax(fold, expb, stats):
    """JAX's variant combinations from tests/test_flash.py, on its shapes,
    the port's wrapper (plain version) against JAX's kernel in interpret
    mode: 2e-5 without exp_bf16; with it, JAX's 3e-2 and the closer
    TOL_EXP_BF16_JAX that the port's plain rounding meets."""
    import jax.numpy as jnp
    from realtime_kv_cache_compression_tpu.ops.pallas import (
        flash_prefill as jfp)

    b = 1 if fold else 2
    q, k, v = _np(8 + b, (b, 256, 4, 32), (b, 256, 2, 32), (b, 256, 2, 32))
    p = 32 if fold else 64
    plens = None if fold else np.array([50, 17], np.int32)
    o_j, pm_j = jfp.flash_prefill_with_prompt_mass(
        *map(jnp.asarray, (q, k, v)), p, block_q=128, block_k=128,
        interpret=True, fold_gqa=bool(fold), exp_bf16=expb,
        stats_via_mxu=stats,
        prompt_lens=None if plens is None else jnp.asarray(plens))
    o_t, pm_t = tfp.flash_prefill_with_prompt_mass(
        *map(torch.from_numpy, (q, k, v)), p,
        prompt_lens=None if plens is None else torch.from_numpy(plens),
        fold_gqa=fold, exp_bf16=expb, stats_via_mxu=stats)
    for tol in ((TOL_EXP_BF16, TOL_EXP_BF16_JAX) if expb else (ATOL,)):
        _close(o_t, o_j, tol)
        _close(pm_t, pm_j, tol)


def test_cli_on_the_cpu_writes_jax_keys_and_best(tmp_path, capsys):
    """The CLI at a tiny shape on the CPU: the plain version once per pair,
    an unbuilt pair recorded as an error, JAX's artifact keys and its
    BEST line last."""
    from realtime_kv_cache_compression_tpu_torch.experiments import (
        kernel_autotune)

    art = kernel_autotune.main([
        "--device", "cpu", "--seq", "128", "--heads", "2", "--kv-heads", "1",
        "--head-dim", "64", "--blocks", "32", "64", "--output-dir",
        str(tmp_path)])
    saved = json.loads((tmp_path / "flash_autotune.json").read_text())
    assert {"results", "best", "shape"} <= set(saved) and saved == json.loads(
        json.dumps(art))
    assert saved["shape"] == {"b": 1, "s": 128, "hq": 2, "hkv": 1, "d": 64}
    errors = {(r["block_q"], r["block_k"]) for r in saved["results"]
              if "error" in r}
    assert errors == {(32, 32), (32, 64), (64, 32)}
    assert (saved["best"]["block_q"], saved["best"]["block_k"]) == (64, 64)
    assert "mean nothing" in saved["timing"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("BEST: block_q=64 block_k=64 ")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _refs(plain, q, k, v, *args, **kw):
    f = [x.float() for x in (q, k, v)]
    return plain(*f, *args, **kw), plain(f[0], f[1], f[2].abs(), *args,
                                         **kw)[0]


def _held(got, refs, exp_bf16=False):
    """A K1 result (o, pm) or (o, lse, pm) against the plain version's:
    o in bf16 within `bf16_output_limit` (float32 within TOL_K1_F32), the
    prompt mass within TOL_MASS, the lse within TOL_LSE where a row sees
    a key; with exp_bf16, o within `bf16_output_limit` in either dtype and
    the prompt mass within TOL_MASS_EXP_BF16."""
    ref, o_abs = refs
    o, pm, o_ref, pm_ref = got[0], got[-1], ref[0], ref[-1]
    if exp_bf16:
        assert tfp.bf16_limit_share(o, o_ref, o_abs) <= 1.0
        assert float((pm - pm_ref).abs().max()) <= TOL_MASS_EXP_BF16
        return
    if o.dtype == torch.bfloat16:
        assert tfp.bf16_limit_share(o, o_ref, o_abs) <= 1.0
    else:
        assert float((o - o_ref).abs().max()) <= TOL_K1_F32
    assert float((pm - pm_ref).abs().max()) <= TOL_MASS
    if len(got) == 3:
        sees = torch.isfinite(ref[1])
        assert torch.equal(sees, torch.isfinite(got[1]))
        assert float((got[1][sees] - ref[1][sees]).abs().max()) <= TOL_LSE


def _mode_calls(cuda, d, dtype, gen, hq=8, hkv=2):
    """(mode, wrapper, its call taking **tile, the plain version's refs)
    for every mode at ragged shapes."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    b = 2
    q, k, v = rnd(b, 333, hq, d), rnd(b, 333, hkv, d), rnd(b, 333, hkv, d)
    plens = torch.tensor([100, 200], device=cuda)
    qc, kb, vb = rnd(b, 150, hq, d), rnd(b, 400, hkv, d), rnd(b, 400, hkv, d)
    qp, kp, vp = rnd(b, 200, hq, d), rnd(b, 300, hkv, d), rnd(b, 300, hkv, d)
    pos = torch.randperm(500, generator=torch.Generator().manual_seed(d))
    kpos = torch.where(torch.rand((b, 300), generator=gen, device=cuda) > .2,
                       pos[:300].to(cuda, torch.int32)[None].expand(b, -1),
                       tfp.POS_SENTINEL).to(torch.int32).contiguous()
    plain_a = prefill_attention_with_prompt_mass
    plain_b = tfp.chunk_attention_with_prompt_mass
    return [
        (tfp._CAUSAL, tfp.flash_prefill_with_prompt_mass,
         lambda **t: tfp.flash_prefill_with_prompt_mass(
             q, k, v, 150, prompt_lens=plens, **t),
         lambda: _refs(plain_a, q, k, v, 150, prompt_lens=plens)),
        (tfp._CAUSAL, tfp.flash_chunk_attention_with_prompt_mass,
         lambda **t: tfp.flash_chunk_attention_with_prompt_mass(
             qc, kb, vb, 97, 150, prompt_lens=plens, **t),
         lambda: _refs(plain_b, qc, kb, vb, 97, 150, prompt_lens=plens)),
        (tfp._CAUSAL, tfp.flash_diagonal_pair_attention,
         lambda **t: tfp.flash_diagonal_pair_attention(
             qp, kp[:, :200], vp[:, :200], plens // 2, **t),
         lambda: _refs(tfp.pair_attention_plain, qp, kp[:, :200],
                       vp[:, :200], plens // 2, causal=True)),
        (tfp._FULL, tfp.flash_full_pair_attention,
         lambda **t: tfp.flash_full_pair_attention(qp, kp, vp, plens, **t),
         lambda: _refs(tfp.pair_attention_plain, qp, kp, vp, plens,
                       causal=False)),
        (tfp._POSITIONED, tfp.flash_positioned_attention,
         lambda **t: tfp.flash_positioned_attention(
             qc, kp, vp, kpos, 250, 150, **t),
         lambda: _refs(tfp.positioned_attention_plain, qc, kp, vp, kpos, 250,
                       150)),
    ]


@pytest.mark.cuda
def test_every_tile_and_variant_matches_plain_on_the_card(cuda):
    """Every built tile of every mode at head_dim 64 and 128, and every
    variant combination at every head_dim (and the fold at n_rep 7),
    launches its own instance (counted by tile and by variant) and holds
    to its plain version; float32 takes its one layout and exp_bf16."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            for mode, fn, kernel, plain in _mode_calls(cuda, d, dtype, gen):
                refs = plain()
                for tile in tfp.built_tiles(mode, d):
                    key = tile if dtype == torch.bfloat16 else "float32"
                    before = fn.tile_launches.get(key, 0)
                    got = kernel(block_q=tile[0], block_k=tile[1])
                    torch.cuda.synchronize()
                    assert fn.tile_launches[key] == before + 1
                    _held(got, refs)
    for d in tfp._HEAD_DIMS:
        for hq, hkv in ((8, 2), (14, 2)):
            q = torch.randn((2, 333, hq, d), generator=gen, device=cuda)
            k, v = (torch.randn((2, 333, hkv, d), generator=gen,
                                device=cuda) for _ in range(2))
            plens = torch.tensor([100, 333], device=cuda)
            for dtype in (torch.bfloat16, torch.float32):
                qd, kd, vd = (x.to(dtype) for x in (q, k, v))
                for var in range(1, 8):
                    flags = {name: bool(var & f)
                             for name, f in tfp.VARIANT_FLAGS}
                    if hq == 14 and not flags["fold_gqa"]:
                        continue
                    refs = _refs(prefill_attention_with_prompt_mass, qd, kd,
                                 vd, 150, prompt_lens=plens,
                                 exp_bf16=flags["exp_bf16"],
                                 exp_block_k=tfp.exp_block_keys(
                                     dtype, tfp.default_tile(tfp._CAUSAL, d)))
                    counts = tfp.flash_prefill_with_prompt_mass.\
                        variant_launches
                    ran = tfp.variant_name(var if dtype == torch.bfloat16
                                           else var & 2)
                    before = counts.get(ran, 0)
                    got = tfp.flash_prefill_with_prompt_mass(
                        qd, kd, vd, 150, prompt_lens=plens, **flags)
                    torch.cuda.synchronize()
                    assert not ran or counts[ran] == before + 1
                    _held(got, refs, exp_bf16=flags["exp_bf16"])


def _default_bits(cuda):
    """SHA-256 of every default K1 call's outputs on seeded bf16 inputs at
    TinyLlama's and Llama-2-7B's heads, every mode."""
    h = hashlib.sha256()
    for d, hq, hkv in ((64, 32, 4), (128, 32, 32)):
        gen = torch.Generator(device=cuda).manual_seed(d)
        for _, _, kernel, _ in _mode_calls(cuda, d, torch.bfloat16, gen, hq,
                                           hkv):
            for t in kernel():
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
    return h.hexdigest()


@pytest.mark.cuda
def test_default_call_keeps_its_bits_after_variants_ran(cuda):
    """The default call gives the same bits before and after every
    non-default tile and variant has been launched in the process."""
    before = _default_bits(cuda)
    q = torch.randn((1, 256, 8, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, 256, 2, 64), device=cuda, dtype=torch.bfloat16)
    for var in range(1, 8):
        tfp.flash_prefill_with_prompt_mass(q, k, k, 64, **{
            name: bool(var & f) for name, f in tfp.VARIANT_FLAGS})
    for tile in tfp.built_tiles(tfp._CAUSAL, 64):
        tfp.flash_prefill_with_prompt_mass(q, k, k, 64, block_q=tile[0],
                                           block_k=tile[1])
    torch.cuda.synchronize()
    assert _default_bits(cuda) == before
