"""The port's HF loading and checkpoints vs the JAX package's (CPU).

Tiny random-init `transformers` models of each family are written with
`save_pretrained` (config.json and safetensors, single-file or sharded
with an index), then read by both packages:
- `config_from_hf` equal to JAX's field by field (Llama with llama3 and
  linear RoPE scaling, Mistral, Qwen2, Gemma, Mixtral);
- the port's safetensors reader equal to `safetensors.safe_open` on every
  dtype it reads (and `safe_open` reading the port's writer), sharded and
  single-file;
- `load_hf_checkpoint` equal to JAX's leaf for leaf, bit for bit. The
  installed `safetensors` cannot give JAX's loader bf16 through numpy
  ("data type 'bfloat16' not understood"), so the bf16 checkpoint is held
  against JAX's `params_from_tensors` over `safe_open(framework="pt")`'s
  tensors instead;
- greedy tokens of `prefill_compressed` + `decode_loop` from a loaded
  checkpoint equal to JAX's;
- `hf_tensors` giving the checkpoint's names and, through
  `params_from_tensors`, the loaded tree back bit for bit;
- `save_checkpoint` / `load_checkpoint` round trips (dense, int8, int4 and
  expert trees, bit-equal) and template mismatches raising;
- `save_params_npz` key names equal to JAX's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors import safe_open
from safetensors.torch import save_file

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.models import weights as jw
from realtime_kv_cache_compression_tpu_torch.models import checkpoint as tc
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models import (
    quantized_params as tq)
from realtime_kv_cache_compression_tpu_torch.models import tensor_files
from realtime_kv_cache_compression_tpu_torch.models import weights as tw

from torch_parity import numpy_tree, to_numpy

DIMS = dict(hidden_size=64, intermediate_size=112, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)
FAMILIES = {
    "llama3": (transformers.LlamaConfig, transformers.LlamaForCausalLM,
               dict(head_dim=16, rope_theta=500000.0, rope_scaling={
                   "rope_type": "llama3", "factor": 8.0,
                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                   "original_max_position_embeddings": 64})),
    "llama_linear": (transformers.LlamaConfig, transformers.LlamaForCausalLM,
                     dict(rope_scaling={"rope_type": "linear",
                                        "factor": 2.0})),
    "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM,
                dict(rms_norm_eps=1e-5)),
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM,
              dict(rope_theta=1e6, tie_word_embeddings=True)),
    "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM,
              dict(head_dim=16, hidden_activation="gelu_pytorch_tanh")),
    "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM,
                dict(num_local_experts=4, num_experts_per_tok=2,
                     rope_theta=1e6)),
}


def _save_hf(family, path, dtype=torch.float32, shard=None, seed=0):
    """A random-init HF model of `family` written by save_pretrained."""
    cfg_cls, model_cls, extra = FAMILIES[family]
    torch.manual_seed(seed)
    model = model_cls(cfg_cls(**DIMS, **extra)).to(dtype)
    with torch.no_grad():  # non-trivial norms and biases
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith(".bias"):
                p.add_(0.1 * torch.randn_like(p))
    kw = {} if shard is None else {"max_shard_size": shard}
    model.save_pretrained(str(path), **kw)
    return str(path)


def _same(a, t, what=""):
    a = np.asarray(a)
    assert str(a.dtype) == str(t.dtype).replace("torch.", ""), what
    assert a.shape == tuple(t.shape), what
    np.testing.assert_array_equal(a.view(np.uint8),
                                  t.cpu().numpy().view(np.uint8)
                                  if t.dtype != torch.bfloat16
                                  else to_numpy(t.cpu()).view(np.uint8),
                                  err_msg=what)


def _same_tree(j, t, path="params"):
    if isinstance(j, dict):
        assert j.keys() == t.keys(), path
        for k in j:
            _same_tree(j[k], t[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            _same_tree(a, b, f"{path}/{i}")
    else:
        _same(j, t, path)


def test_config_from_hf_matches_jax(tmp_path):
    for family in FAMILIES:
        cfg_cls, _, extra = FAMILIES[family]
        d = tmp_path / family
        cfg_cls(**DIMS, **extra).save_pretrained(str(d))
        j, t = jw.config_from_hf(str(d)), tw.config_from_hf(str(d))
        assert dataclasses.asdict(j) == dataclasses.asdict(t), family
    assert t.num_experts == 4 and j.rope_scaling is None
    assert tw.config_from_hf(str(tmp_path / "llama3")).rope_scaling.kind \
        == "llama3"


def test_reader_matches_safe_open(tmp_path):
    """Every readable dtype, single-file and sharded (save_pretrained with
    an index), and the port's writer read back by safe_open."""
    gen = torch.Generator().manual_seed(0)
    tensors = {f"t_{dt}": (torch.randn((3, 5), generator=gen) * 50).to(dt)
               for dt in tensor_files.DTYPES.values()}
    tensors["scalar"] = torch.tensor(2.5)
    tensors["empty"] = torch.zeros((0, 4))
    save_file(tensors, str(tmp_path / "all.safetensors"),
              metadata={"format": "pt"})
    tensor_files.save_tensors(str(tmp_path / "ours.safetensors"), tensors,
                              metadata={"format": "pt"})
    sharded = _save_hf("llama3", tmp_path / "sharded", dtype=torch.bfloat16,
                       shard="40KB")
    assert (tmp_path / "sharded" / tensor_files.INDEX_NAME).exists()
    handles = tensor_files.open_checkpoint(sharded)
    assert len({h.path for h in handles.values()}) > 1
    for path, names in ((tmp_path / "all.safetensors", tensors),
                        (tmp_path / "ours.safetensors", tensors)):
        ours = tensor_files.TensorFile(str(path))
        assert ours.metadata == {"format": "pt"}
        with safe_open(str(path), framework="pt") as f:
            assert set(f.keys()) == set(ours.keys()) == set(names)
            for k in names:
                assert torch.equal(ours.get(k), f.get_tensor(k)), k
    for name, h in handles.items():
        with safe_open(h.path, framework="pt") as f:
            assert torch.equal(h.get(name), f.get_tensor(name)), name
    save_file({"x": torch.zeros(2, dtype=torch.float64)},
              str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        tensor_files.TensorFile(str(tmp_path / "f64.safetensors"))


@pytest.mark.parametrize("family,dtype,shard", [
    ("mixtral", torch.float32, "60KB"), ("gemma", torch.float32, None),
    ("qwen2", torch.bfloat16, "40KB")])
def test_load_hf_checkpoint_matches_jax(tmp_path, family, dtype, shard):
    path = _save_hf(family, tmp_path, dtype=dtype, shard=shard)
    cfg = tw.config_from_hf(path)
    got = tw.load_hf_checkpoint(path, device="cpu")
    if dtype == torch.bfloat16:
        # JAX's loader reads no bf16 through safetensors' numpy framework:
        # its params_from_tensors over safe_open's torch tensors.
        handles = tensor_files.open_checkpoint(path)

        def get(name):
            with safe_open(handles[name].path, framework="pt") as f:
                return to_numpy(f.get_tensor(name))

        want = jw.params_from_tensors(get, jw.config_from_hf(path),
                                      jnp.bfloat16)
    else:
        want = jw.load_hf_checkpoint(path)
    if family == "mixtral":
        assert got["layers"][0]["moe"]["w_gate"].shape == (
            4, cfg.hidden_size, cfg.intermediate_size)
    _same_tree(numpy_tree(want), got)
    assert all(t.is_contiguous() for t in jax.tree_util.tree_leaves(got))
    # hf_tensors is its inverse: the checkpoint's names, and the tree back
    # bit for bit.
    back = tw.hf_tensors(got, cfg)
    assert back.keys() == tensor_files.open_checkpoint(path).keys()
    tc.check_like(tw.params_from_tensors(back.__getitem__, cfg,
                                         got["embed"].dtype, device="cpu"),
                  got, exact=True)


def test_loaded_checkpoint_generates_like_jax(tmp_path):
    """A Llama-3-scaled checkpoint loaded by both packages: kept positions
    and greedy tokens of the compressed prefill + decode equal."""
    path = _save_hf("llama3", tmp_path, shard="40KB", seed=3)
    jcfg, tcfg = jw.config_from_hf(path), tw.config_from_hf(path)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    jp = jw.load_hf_checkpoint(path, jcfg)
    tp = tw.load_hf_checkpoint(path, tcfg, device="cpu")
    ids = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 64))
    steps = 6
    jcc = rj.CompressionConfig(num_layers=jcfg.num_layers)
    tcc = rt.CompressionConfig(num_layers=tcfg.num_layers)

    def run_j(p, i):
        logits, state, _ = jl.prefill_compressed(
            p, i, jcfg, jcc, max_decode_len=steps, use_flash=False)
        toks, _ = jl.decode_loop(p, jnp.argmax(logits, -1), state, steps,
                                 jcfg, jcc, use_fused=False)
        return toks, state

    j_toks, j_state = jax.jit(run_j)(jp, jnp.asarray(ids))
    logits, t_state, _ = tl.prefill_compressed(
        tp, torch.from_numpy(ids), tcfg, tcc, max_decode_len=steps)
    t_toks, _ = tl.decode_loop(tp, torch.argmax(logits, -1), t_state, steps,
                               tcfg, tcc)
    for jc, c in zip(numpy_tree(j_state.caches), t_state.caches):
        for a, b in zip(jc.tiers, c.tiers):
            np.testing.assert_array_equal(a.positions, b.positions.numpy())
    np.testing.assert_array_equal(np.asarray(j_toks), t_toks.numpy())


def test_checkpoint_round_trip(tmp_path):
    cfg = rt.tiny_test_model(num_layers=2, dtype="bfloat16")
    moe_cfg = rt.tiny_test_model(num_layers=1, num_experts=4)
    dense = tl.init_params(0, cfg, device="cpu")
    moe = tl.init_params(1, moe_cfg, device="cpu")
    trees = {
        "dense": dense,
        "int8": tq.quantize_params(dense, bits=8, act_quant=True),
        "int4": tl.fuse_params(tq.quantize_params(dense, bits=4,
                                                  group_size=16)),
        "experts_int4": tq.quantize_params(moe, bits=4, group_size=16),
        "experts_int8": tq.quantize_params(moe, bits=8),
        "misc": {"step": 7, "lr": 1e-3, "name": "x", "none": None,
                 "pair": (torch.arange(3), [torch.ones(2, 2)])},
    }
    for name, tree in trees.items():
        tc.save_checkpoint(str(tmp_path / name), tree)
        tc.check_like(tc.load_checkpoint(str(tmp_path / name),
                                         device="cpu"), tree, exact=True)
        tc.check_like(tc.load_checkpoint(
            str(tmp_path / name), template=tree, device="cpu"), tree,
            exact=True)
    wrong = tq.quantize_params(dense, bits=4, group_size=32)
    with pytest.raises(ValueError, match="scale"):
        tc.load_checkpoint(str(tmp_path / "int4"), template=tl.fuse_params(
            wrong), device="cpu")
    with pytest.raises(ValueError, match="template"):
        tc.load_checkpoint(str(tmp_path / "int8"),
                           template=trees["dense"], device="cpu")
    with open(tmp_path / "int4" / tc.FILE_NAME, "rb") as f:
        f.read(8)
        assert b"__metadata__" in f.read(4096)
    assert json.loads(tensor_files.TensorFile(
        str(tmp_path / "dense" / tc.FILE_NAME)).metadata["tree"])


def test_save_params_npz_names_match_jax(tmp_path):
    cfg = rt.tiny_test_model(num_layers=2, dtype="bfloat16", qkv_bias=True)
    params = tl.init_params(0, cfg, device="cpu")
    from torch_parity import jax_tree
    jw.save_params_npz(str(tmp_path / "j.npz"), jax_tree(params))
    tw.save_params_npz(str(tmp_path / "t.npz"), params)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert j.files == t.files
    for k in j.files:  # bf16 stored as raw 16-bit patterns by the port
        assert t[k].dtype == np.uint16
        np.testing.assert_array_equal(j[k].view(np.uint16), t[k])
