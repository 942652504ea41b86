"""Quantized weights for the params tree (PyTorch port).

Port of the JAX package's `models/quantized_params.py`: per-out-channel
symmetric int8 weights (`QuantizedTensor`, optionally with per-token int8
activations, the W8A8 path that runs K4) and group-wise symmetric int4
weights (`Int4Tensor`, nibble-packed, the path that runs K3). The
embedding quantizes per row and, like `lm_head`, stays int8 under
`bits=4`. Codes, packed bytes and scales are computed in the same float32
order as the reference, so they are byte-identical to it.

`llama._matmul` dispatches on these classes. MoE layers' expert stacks
quantize to `QuantizedExpertTensor` (int8 per expert and out-channel) or,
at `bits=4`, `Int4ExpertTensor` (the same packed layout with a leading
expert axis, whose routed experts run K3's expert-indexed GEMV in decode,
ops/moe.py); the router gate stays full precision.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class QuantizedTensor:
    """Symmetric per-channel int8 weight: w ≈ q * scale.

    q: [in, out] int8 with scale [out] float32 (axis=1), or [vocab, hidden]
    with a per-row scale [vocab] (axis=0, the embedding). act_quant routes
    the matmul through K4 with per-token int8 activations.
    """

    q: torch.Tensor
    scale: torch.Tensor
    axis: int = 1
    act_quant: bool = False

    @property
    def shape(self):
        return tuple(self.q.shape)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        scale = self.scale[:, None] if self.axis == 0 else self.scale[None, :]
        return (self.q.float() * scale).to(dtype)


def quantize_tensor(w: torch.Tensor, axis: int = 1,
                    act_quant: bool = False) -> QuantizedTensor:
    """Symmetric int8 quantization along `axis` (the preserved channel)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1 - axis)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    scale_b = scale[:, None] if axis == 0 else scale[None, :]
    q = torch.clamp(torch.round(wf / scale_b), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale, axis=axis, act_quant=act_quant)


@dataclasses.dataclass
class Int4Tensor:
    """Group-wise symmetric int4 weight: w[i, o] ≈ q[i, o] · s[i // G, o].

    Codes are offset-binary, u = q + 8 in [1, 15], packed in the reference's
    half-split layout: uint8 `q_packed[p, o]` holds row p in its low nibble
    and row p + in_dim/2 in its high nibble. Scales are [in_dim // G, out]
    float32; one group covers the whole in_dim when in_dim % (2 G) != 0.
    """

    q_packed: torch.Tensor  # [in_dim // 2, out] uint8
    scale: torch.Tensor     # [in_dim // G, out] float32
    in_dim: int = 0

    @property
    def shape(self):
        return (self.in_dim, self.q_packed.shape[-1])

    @property
    def group_size(self) -> int:
        return self.in_dim // self.scale.shape[0]

    def unpack_codes(self) -> torch.Tensor:
        """[in_dim, out] int8 codes in [-7, 7]."""
        p = self.q_packed.to(torch.int32)
        return torch.cat([(p & 0xF) - 8, (p >> 4) - 8]).to(torch.int8)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        n_g = self.scale.shape[0]
        codes = self.unpack_codes().float()
        w = codes.reshape(n_g, self.group_size, -1) * self.scale[:, None, :]
        return w.reshape(self.in_dim, -1).to(dtype)


def quantize_tensor_int4(w: torch.Tensor, group_size: int = 128
                         ) -> Int4Tensor:
    """Symmetric group-wise int4 quantization along the reduction axis.

    Falls back to a single group when in_dim % (2 * group_size) != 0 (the
    kernel needs whole groups in each packed half); in_dim must be even.
    """
    wf = w.float()
    in_dim, out = wf.shape
    if in_dim % 2:
        raise ValueError(f"int4 packing needs even in_dim, got {in_dim}")
    g = group_size if in_dim % (2 * group_size) == 0 else in_dim
    grouped = wf.reshape(in_dim // g, g, out)
    absmax = grouped.abs().amax(dim=1)
    scale = torch.clamp_min(absmax, 1e-8) / 7.0
    q = torch.clamp(torch.round(grouped / scale[:, None, :]), -7, 7)
    u = (q + 8).to(torch.uint8).reshape(in_dim, out)
    half = in_dim // 2
    packed = (u[half:] << 4) | u[:half]
    return Int4Tensor(q_packed=packed, scale=scale, in_dim=in_dim)


@dataclasses.dataclass
class QuantizedExpertTensor:
    """Per-(expert, out-channel) symmetric int8 MoE weight stack:
    w[e, i, o] ≈ q[e, i, o] · scale[e, o]."""

    q: torch.Tensor      # [E, in, out] int8
    scale: torch.Tensor  # [E, out] float32

    @property
    def shape(self):
        return tuple(self.q.shape)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale[:, None, :]).to(dtype)


def quantize_expert_tensor(w: torch.Tensor) -> QuantizedExpertTensor:
    """Symmetric int8 over each expert's reduction axis (axis 1)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1)                    # [E, out]
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -127, 127)
    return QuantizedExpertTensor(q=q.to(torch.int8), scale=scale)


@dataclasses.dataclass
class Int4ExpertTensor:
    """Group-wise int4 MoE expert stack: `Int4Tensor`'s half-split,
    offset-binary packed layout with a leading expert axis."""

    q_packed: torch.Tensor  # [E, in_dim // 2, out] uint8
    scale: torch.Tensor     # [E, in_dim // G, out] float32
    in_dim: int = 0

    @property
    def shape(self):
        return (self.q_packed.shape[0], self.in_dim, self.q_packed.shape[-1])

    @property
    def group_size(self) -> int:
        return self.in_dim // self.scale.shape[1]

    def expert(self, e: int) -> Int4Tensor:
        """One expert's weight (views of the stack; `e` a host int)."""
        return Int4Tensor(q_packed=self.q_packed[e], scale=self.scale[e],
                          in_dim=self.in_dim)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        p = self.q_packed.to(torch.int32)
        codes = torch.cat([(p & 0xF) - 8, (p >> 4) - 8], dim=1).float()
        e, _, out = p.shape
        n_g = self.scale.shape[1]
        w = (codes.reshape(e, n_g, self.group_size, out)
             * self.scale[:, :, None, :])
        return w.reshape(e, self.in_dim, out).to(dtype)


def quantize_expert_tensor_int4(w: torch.Tensor, group_size: int = 128
                                ) -> Int4ExpertTensor:
    """Group-wise symmetric int4 along each expert's reduction axis: the
    grouping and packing of `quantize_tensor_int4`, over the expert axis."""
    wf = w.float()
    e, in_dim, out = wf.shape
    if in_dim % 2:
        raise ValueError(f"int4 packing needs even in_dim, got {in_dim}")
    g = group_size if in_dim % (2 * group_size) == 0 else in_dim
    grouped = wf.reshape(e, in_dim // g, g, out)
    absmax = grouped.abs().amax(dim=2)
    scale = torch.clamp_min(absmax, 1e-8) / 7.0
    q = torch.clamp(torch.round(grouped / scale[:, :, None, :]), -7, 7)
    u = (q + 8).to(torch.uint8).reshape(e, in_dim, out)
    half = in_dim // 2
    packed = (u[:, half:] << 4) | u[:, :half]
    return Int4ExpertTensor(q_packed=packed, scale=scale, in_dim=in_dim)


_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "wqkv", "w_gateup")  # fused names: llama.fuse_params
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _check_args(bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"weight bits must be 4 or 8, got {bits}")


def _quantize_expert_entry(k: str, v, bits: int, group_size: int):
    """An entry of a layer's "moe" dict, quantized when it is an expert
    stack (the router gate stays full precision: tiny, routing-critical)."""
    if k not in _EXPERT_KEYS:
        return v
    if bits == 4:
        return quantize_expert_tensor_int4(v, group_size=group_size)
    return quantize_expert_tensor(v)


def _quantize_entry(k: str, v, bits: int, act_quant: bool, group_size: int):
    """A layer entry, quantized when it is a matmul weight or a "moe"
    dict."""
    if k == "moe":
        return {mk: _quantize_expert_entry(mk, mv, bits, group_size)
                for mk, mv in v.items()}
    if k not in _MATMUL_KEYS:
        return v
    if bits == 4:
        return quantize_tensor_int4(v, group_size=group_size)
    return quantize_tensor(v, axis=1, act_quant=act_quant)


def quantize_params(params: Dict[str, Any], act_quant: bool = False,
                    bits: int = 8, group_size: int = 128) -> Dict[str, Any]:
    """Quantize all matmul weights (+ embed / lm_head) of a llama params tree.

    act_quant=True (int8 only) routes the layer matmuls and lm_head through
    K4 with per-token int8 activations. bits=4 stores the layer matmul
    weights as `Int4Tensor`s; embed and lm_head stay int8.
    """
    _check_args(bits)
    out: Dict[str, Any] = {
        "embed": quantize_tensor(params["embed"], axis=0),  # per row
        "final_norm": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"], axis=1,
                                         act_quant=act_quant)
    out["layers"] = [
        {k: _quantize_entry(k, v, bits, act_quant, group_size)
         for k, v in layer.items()} for layer in params["layers"]]
    return out


def quantize_params_streaming(params: Dict[str, Any],
                              act_quant: bool = False, bits: int = 8,
                              group_size: int = 128) -> Dict[str, Any]:
    """Like `quantize_params`, but CONSUMES the input tree: each weight's
    last reference in the tree is dropped as soon as its quantized
    replacement exists, so peak device memory is the full-precision tree
    plus one tensor (when the caller holds no other reference)."""
    _check_args(bits)
    out: Dict[str, Any] = {"layers": []}
    out["embed"] = quantize_tensor(params["embed"], axis=0)
    params["embed"] = None
    out["final_norm"] = params.pop("final_norm")
    if "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"], axis=1,
                                         act_quant=act_quant)
        params["lm_head"] = None
    layers = params["layers"]
    for i in range(len(layers)):
        layer = layers[i]
        ql = {}
        for k in list(layer.keys()):
            v = layer.pop(k)
            if k == "moe":  # each expert stack dropped once quantized
                ql[k] = {mk: _quantize_expert_entry(mk, v.pop(mk), bits,
                                                    group_size)
                         for mk in list(v.keys())}
            else:
                ql[k] = _quantize_entry(k, v, bits, act_quant, group_size)
            del v
        layers[i] = None
        out["layers"].append(ql)
    return out


_QUANTIZED = (QuantizedTensor, Int4Tensor, QuantizedExpertTensor,
              Int4ExpertTensor)


def _leaves(tree):
    """The leaves of a params tree: tensors and quantized weights."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _tensors(leaf):
    if isinstance(leaf, _QUANTIZED):
        return [getattr(leaf, f.name) for f in dataclasses.fields(leaf)
                if isinstance(getattr(leaf, f.name), torch.Tensor)]
    return [leaf]


def params_to(params: Any, device) -> Any:
    """The params tree, quantized leaves included, with every tensor on
    `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    if isinstance(params, _QUANTIZED):
        return dataclasses.replace(params, **{
            f.name: getattr(params, f.name).to(device)
            for f in dataclasses.fields(params)
            if isinstance(getattr(params, f.name), torch.Tensor)})
    return params.to(device)


def params_are_quantized(params: Any) -> bool:
    """True when the tree carries int8 / int4 quantized weights (dense or
    expert stacks)."""
    return any(isinstance(x, _QUANTIZED) for x in _leaves(params))


def params_bytes(params: Any) -> int:
    """Bytes stored by every tensor of the tree."""
    return sum(t.numel() * t.element_size()
               for x in _leaves(params) for t in _tensors(x))


def params_num_weights(params: Any) -> int:
    """Logical weight count, independent of storage precision: a packed
    int4 byte counts 2 elements, an int8 code 1, scales 1 each."""
    total = 0
    for x in _leaves(params):
        total += sum(t.numel() for t in _tensors(x))
        if isinstance(x, (Int4Tensor, Int4ExpertTensor)):
            total += x.q_packed.numel()  # the second weight of each byte
    return total
