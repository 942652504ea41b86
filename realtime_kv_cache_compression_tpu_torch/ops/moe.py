"""Mixture-of-Experts MLP (Mixtral-style): routing and four strategies.

Port of the JAX package's `ops/moe.py`. Routing follows HF Mixtral
(`MixtralSparseMoeBlock`): softmax over all expert logits in float32,
top-k, then the kept weights renormalised. The strategies compute the same
function and differ in what they read:

* ``ragged`` — token-slot rows sorted by expert id, one product per
  expert over its contiguous group (JAX runs `jax.lax.ragged_dot`, a
  library op, not a Pallas kernel; here a plain matmul per group). The
  group sizes are read to the host once per call: one device read per
  MoE layer of a prefill.
* ``gather`` — each token's routed experts gathered into an
  [N, k, in, out] buffer and contracted in one einsum.
* ``dynslice`` — per routed expert and projection one matvec over that
  expert's weights. With `Int4ExpertTensor` stacks it runs K3's
  expert-indexed GEMV (ops/cuda/int4_matmul.py, `int4_matmul_expert`):
  the kernel reads the expert id from device memory, so decode reads each
  routed expert's packed codes once, with no host read and no copy. As in
  JAX, its input is cast to bf16 (even in a float32 model) and its output
  back to float32. Raw and int8 stacks take the expert by `index_select`
  on the device id (a copy of the expert; no host read).
* ``dense`` — every expert on every token, combined with the sparse
  routing weights.

int8 stacks (`QuantizedExpertTensor`) keep their scale where JAX applies
it: on the projection output. `moe_mlp`'s "auto" takes dynslice at N <= 8
tokens, gather at N <= 16, ragged beyond; int4 stacks are dequantized up
front (to bf16, as JAX's default) on every strategy but dynslice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.quantized_params import Int4ExpertTensor, QuantizedExpertTensor
from .cuda.int4_matmul import int4_matmul_expert

# Below this many tokens the gather path reads less expert weight than a
# grouped product over all experts (decode / tiny prefill).
_GATHER_MAX_TOKENS = 16
# Below this many tokens the per-expert matvecs read each routed expert
# once: N * k * 3 launches, decode-sized.
_DYNSLICE_MAX_TOKENS = 8


def router_topk(x2: torch.Tensor, gate: torch.Tensor, num_experts_per_tok: int,
                norm_topk: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing (HF Mixtral semantics). x2: [N, H] tokens, gate:
    [H, E]. Returns (weights [N, k] float32, expert ids [N, k] int32)."""
    probs = torch.softmax(x2.float() @ gate.float(), dim=-1)   # [N, E]
    # A stable descending sort puts the lower expert first among equal
    # probabilities, as jax.lax.top_k does (torch.topk promises no order).
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :num_experts_per_tok], ids[:, :num_experts_per_tok]
    if norm_topk:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, ids.to(torch.int32)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu_tanh":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown hidden_act {name!r}")


def _codes(wt) -> torch.Tensor:
    """An expert stack's codes or values [E, in, out]."""
    return wt.q if isinstance(wt, QuantizedExpertTensor) else wt


def _scale(wt) -> Optional[torch.Tensor]:
    return wt.scale if isinstance(wt, QuantizedExpertTensor) else None


def _pmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (JAX's promotion: bf16 @
    float32 is float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _moe_ragged(moe: Dict, x2: torch.Tensor, w: torch.Tensor,
                ids: torch.Tensor, num_experts: int, act: str
                ) -> torch.Tensor:
    """Rows sorted by expert (stable: ties keep token order), one product
    per expert's contiguous group."""
    n, k = ids.shape
    flat_ids = ids.reshape(-1).long()                       # [N*k]
    order = torch.argsort(flat_ids, stable=True)
    xs = torch.repeat_interleave(x2, k, dim=0)[order]
    sorted_ids = flat_ids[order]
    sizes = torch.bincount(flat_ids, minlength=num_experts).tolist()

    def rdot(lhs, wt):
        codes = _codes(wt)
        parts, start = [], 0
        for e, size in enumerate(sizes):
            parts.append(lhs[start:start + size] @ codes[e].to(lhs.dtype))
            start += size
        y = torch.cat(parts)
        s = _scale(wt)
        # Row r belongs to expert sorted_ids[r]: its per-out scale applies
        # to the projection output.
        return y if s is None else (y * s[sorted_ids]).to(y.dtype)

    h1 = rdot(xs, moe["w_gate"])
    h2 = rdot(xs, moe["w_up"])
    ys = rdot((_act(h1, act) * h2).to(xs.dtype), moe["w_down"])
    y = ys[torch.argsort(order)].reshape(n, k, -1)          # unsorted
    return (y * w[..., None].to(y.dtype)).sum(dim=1)


def _moe_gather(moe: Dict, x2: torch.Tensor, w: torch.Tensor,
                ids: torch.Tensor, act: str) -> torch.Tensor:
    """Each token's routed experts gathered, then one einsum."""
    idx = ids.long()

    def gdot(spec, lhs, wt):
        y = torch.einsum(spec, lhs, _codes(wt)[idx].to(lhs.dtype))
        s = _scale(wt)
        return y if s is None else (y * s[idx]).to(y.dtype)

    h1 = gdot("nh,nkhi->nki", x2, moe["w_gate"])
    h2 = gdot("nh,nkhi->nki", x2, moe["w_up"])
    y = gdot("nki,nkih->nkh", (_act(h1, act) * h2).to(x2.dtype),
             moe["w_down"])
    return (y * w[..., None].to(y.dtype)).sum(dim=1)


def _dot_f32(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """x @ mat.to(x.dtype) with a float32 result (JAX's
    `preferred_element_type=float32`): both operands go to float32, the
    same products."""
    return x.float() @ mat.to(x.dtype).float()


def _moe_dynslice(moe: Dict, x2: torch.Tensor, w: torch.Tensor,
                  ids: torch.Tensor, act: str) -> torch.Tensor:
    """Per routed expert and projection one matvec over that expert alone
    (decode-sized N: N * k * 3 of them); the expert id stays on the
    device."""
    flat = ids.reshape(-1).contiguous()

    def sdot(lhs, wt, slot):
        if isinstance(wt, Int4ExpertTensor):
            # K3's GEMV over one expert's packed codes, its id read by the
            # kernel (bf16 input, as JAX's moe.py casts it).
            y = int4_matmul_expert(lhs[None].to(torch.bfloat16), wt.q_packed,
                                   wt.scale, flat, slot)[0]
            return y.float()
        e = flat[slot:slot + 1].long()
        y = _dot_f32(lhs[None], torch.index_select(_codes(wt), 0, e)[0])[0]
        s = _scale(wt)
        return y if s is None else y * torch.index_select(s, 0, e)[0]

    n, k = ids.shape
    outs = []
    for t in range(n):
        xt = x2[t]
        acc = torch.zeros((x2.shape[1],), dtype=torch.float32,
                          device=x2.device)
        for j in range(k):
            slot = t * k + j
            h1 = sdot(xt, moe["w_gate"], slot)
            h2 = sdot(xt, moe["w_up"], slot)
            y = sdot((_act(h1, act) * h2).to(xt.dtype), moe["w_down"], slot)
            acc = acc + w[t, j] * y
        outs.append(acc)
    return torch.stack(outs)


def _moe_dense(moe: Dict, x2: torch.Tensor, w: torch.Tensor,
               ids: torch.Tensor, num_experts: int, act: str) -> torch.Tensor:
    """Every expert on every token, combined with the sparse routing
    weights."""
    n = x2.shape[0]
    combine = torch.zeros((n, num_experts), dtype=x2.dtype, device=x2.device)
    rows = torch.arange(n, device=x2.device)[:, None].expand_as(ids)
    combine.index_put_((rows, ids.long()), w.to(x2.dtype), accumulate=True)

    def edot(spec, lhs, wt):
        y = torch.einsum(spec, lhs, _codes(wt).to(lhs.dtype))
        s = _scale(wt)
        return y if s is None else (y * s[None]).to(y.dtype)

    h1 = edot("nh,ehi->nei", x2, moe["w_gate"])
    h2 = edot("nh,ehi->nei", x2, moe["w_up"])
    y = edot("nei,eih->neh", (_act(h1, act) * h2).to(x2.dtype),
             moe["w_down"])
    return torch.einsum("ne,neh->nh", combine.to(y.dtype), y)


def moe_mlp(moe: Dict, x: torch.Tensor, cfg,
            impl: Optional[str] = None) -> torch.Tensor:
    """Sparse MoE MLP over [..., H] hidden states.

    `moe` holds `gate` [H, E], `w_gate` / `w_up` [E, H, I] and `w_down`
    [E, I, H] (raw tensors or expert stacks). `impl` overrides
    cfg.moe_impl ("auto" | "ragged" | "gather" | "dynslice" | "dense")."""
    impl = impl or getattr(cfg, "moe_impl", "auto")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    n = x2.shape[0]
    dynslice = impl == "dynslice" or (impl == "auto"
                                      and n <= _DYNSLICE_MAX_TOKENS)
    if not dynslice:
        # The batched strategies take int4 experts dequantized (bf16): a
        # prefill-sized product hides the transient bytes.
        moe = {k: (v.dequantize() if isinstance(v, Int4ExpertTensor) else v)
               for k, v in moe.items()}
    w, ids = router_topk(x2, moe["gate"], cfg.num_experts_per_tok)
    if impl == "auto":
        impl = ("dynslice" if dynslice else
                "gather" if n <= _GATHER_MAX_TOKENS else "ragged")
    if impl == "ragged":
        out = _moe_ragged(moe, x2, w, ids, cfg.num_experts, cfg.hidden_act)
    elif impl == "gather":
        out = _moe_gather(moe, x2, w, ids, cfg.hidden_act)
    elif impl == "dynslice":
        out = _moe_dynslice(moe, x2, w, ids, cfg.hidden_act)
    elif impl == "dense":
        out = _moe_dense(moe, x2, w, ids, cfg.num_experts, cfg.hidden_act)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    return out.reshape(shape).to(x.dtype)


def moe_mlp_reference(moe: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Slow per-expert masked loop over dequantized (float32) experts: the
    oracle for tests."""
    moe = {k: (v.dequantize(torch.float32)
               if isinstance(v, (QuantizedExpertTensor, Int4ExpertTensor))
               else v)
           for k, v in moe.items()}
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    w, ids = router_topk(x2, moe["gate"], cfg.num_experts_per_tok)
    out = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    for e in range(cfg.num_experts):
        h1 = _pmm(x2, moe["w_gate"][e])
        h2 = _pmm(x2, moe["w_up"][e])
        y = _pmm(_act(h1, cfg.hidden_act) * h2, moe["w_down"][e])  # [N, H]
        weight = torch.where(ids == e, w, 0.0).sum(dim=1)         # [N]
        out = out + weight[:, None] * y.float()
    return out.reshape(shape).to(x.dtype)
