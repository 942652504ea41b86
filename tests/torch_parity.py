"""Helpers shared by the port's parity tests (not a test module).

The JAX package stays the reference: these move its containers over to the
port's and hold whole-model caches to the limit that upstream float32
rounding allows.
"""

import jax
import numpy as np
import torch

from realtime_kv_cache_compression_tpu_torch.compression import (
    kv_cache as tk)
from realtime_kv_cache_compression_tpu_torch.config import HIGH, LOW, MID
from realtime_kv_cache_compression_tpu_torch.ops.quantization import (
    unpack_codes)

# Upstream float32 values (matmul and RoPE rounding) may differ in the last
# bit between the two frameworks, and a value on a rounding boundary then
# quantizes to the neighbouring code: at most this many codes per layer,
# each one step off (tests/test_torch_llama.py checks it over four seeds).
MAX_CODE_FLIPS = 2


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_tree(tree):
    """The port's params (CPU tensors) as a JAX params tree: random weights
    made once by the port's `init_params` from a seed feed both packages,
    and the JAX side compiles no initialiser. The port's quantized leaves
    become the JAX package's classes of the same name and fields."""
    import dataclasses

    from realtime_kv_cache_compression_tpu.models import quantized_params

    def conv(x):
        if dataclasses.is_dataclass(x):
            cls = getattr(quantized_params, type(x).__name__)
            return cls(**{f.name: conv(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
        if isinstance(x, torch.Tensor):
            return jax.numpy.asarray(to_numpy(x))
        return x

    return jax.tree_util.tree_map(conv, tree,
                                  is_leaf=dataclasses.is_dataclass)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bf16 as ml_dtypes' bfloat16."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_to_jax(state):
    """The port's `DecodeState` (CPU tensors) as the JAX package's, so both
    packages decode from one prefill."""
    from realtime_kv_cache_compression_tpu.compression import kv_cache as jk
    from realtime_kv_cache_compression_tpu.models import llama as jl

    def conv(obj, cls):
        return cls(**{f: (jax.numpy.asarray(v.numpy())
                          if isinstance(v, torch.Tensor) else v)
                      for f, v in vars(obj).items()})

    return jl.DecodeState(
        caches=tuple(jk.CompressedLayerCache(tiers=tuple(
            conv(t, jk.TierCache) for t in c.tiers)) for c in state.caches),
        recents=tuple(conv(r, jk.RecentCache) for r in state.recents),
        position=jax.numpy.asarray(state.position.numpy()),
        pools=tuple(None if p is None else conv(p, jk.DecodePool)
                    for p in state.pools))


def to_torch(x) -> torch.Tensor:
    a = np.array(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no torch numpy type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def cache_to_torch(cache) -> tk.CompressedLayerCache:
    """A JAX `CompressedLayerCache` as the port's (CPU tensors)."""
    return tk.CompressedLayerCache(tiers=tuple(
        tk.TierCache(**{f: to_torch(getattr(t, f)) for f in (
            "k_stored", "v_stored", "k_scale", "k_zp", "v_scale", "v_zp",
            "positions", "valid")}, chunk=t.chunk) for t in cache.tiers))


def assert_caches_match(j_caches, t_caches, ccfg,
                        max_flips: int = MAX_CODE_FLIPS) -> None:
    """Kept positions, validity and chunks identical; packed codes equal up
    to `max_flips` one-step codes per layer."""
    for a_cache, t_cache in zip(j_caches, t_caches, strict=True):
        flips = 0
        for tier, a, t in zip((HIGH, MID, LOW), a_cache.tiers, t_cache.tiers):
            assert a.chunk == t.chunk
            for f in ("positions", "valid"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, f)), getattr(t, f).cpu().numpy(),
                    err_msg=f)
            bits = ccfg.tier_bits(tier)
            for f in ("k_stored", "v_stored"):
                ja = to_torch(getattr(a, f))
                tb = getattr(t, f).cpu()
                if bits == 16:
                    assert torch.equal(ja, tb), f
                    continue
                codes = [unpack_codes(x, bits, t.capacity, axis=-3,
                                      chunk=t.chunk).int() for x in (ja, tb)]
                off = (codes[0] - codes[1]).abs()
                assert bool((off <= 1).all()), f
                flips += int((off > 0).sum())
        assert flips <= max_flips, flips
