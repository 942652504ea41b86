"""Tensor and data parallelism over a (data, model) mesh of ranks.

Port of the JAX package's `parallel/sharding.py`. JAX places each leaf on
a device mesh by a PartitionSpec and lets GSPMD partition the program; the
port runs one process per rank, so each rank keeps only its slice of
every leaf (`shard_params`) and the model code runs the Megatron-style
collectives itself (`comm.py`, over the mesh's groups):

- `model` axis: whole attention heads (query heads r·Hq/m .. (r+1)·Hq/m - 1
  on model rank r, with the kv heads they read), the MLP's intermediate
  columns, the experts of a MoE layer and the vocabulary. `wq`, `wk`,
  `wv` (and Qwen2's biases) by column, `wo` by row, then one SUM
  all-reduce; `w_gate` / `w_up` by column, `w_down` by row, then one SUM
  all-reduce; `embed` by vocab row (a masked lookup and one SUM
  all-reduce, exact: one rank gives each row, the others zeros);
  `lm_head` (or the tied `embed`) by vocab column, the logits gathered
  over the axis before any argmax or sampling; the experts by their
  [E] axis (`expert_parallel.ep_moe_mlp`); norms and the router
  replicated. The partial sums of `wo` and `w_down` are products in
  float32 (bf16 operands widened, exact products), reduced in float32 and
  rounded once to the model dtype: against one rank, whose matmul rounds
  its float32 accumulation once, only the order of the float32 sum
  differs.
- `data` axis: the batch rows; the model's functions take each data
  rank's rows of the ids and lengths, and gather the logits and the
  per-row stats.

A dimension the axis does not divide is replicated instead, the outcome
of JAX's `_feasible_spec`, but in whole heads: the attention is sharded
only when `model` divides the query heads and either divides the kv heads
or gives every rank query heads of one kv head (Gemma-2B's single kv head
is then held, with its caches, by every rank); otherwise every rank runs
every head. JAX splits such a head's columns and lets GSPMD mend it.

The prompt mass each rank's attention gives per head is gathered over
`model` before the mean over heads (`ops/attention.head_mean`), so every
model rank scores and selects the same tokens by construction. The byte
stats count the model's whole kv width, and over `data` the batch-wide
counts are all-reduced before the ratios are formed: the stats are those
of JAX's global arrays.

A sharded tree (`ShardedParams`) carries its `ShardLayout`, and the
prefill and decode functions of `models/llama.py` pick it up: `mesh=` on
them (where JAX has it) checks the state they return
(`constrain_decode_state`, a check here: there is no GSPMD to re-lay a
state). Quantized and fused trees are refused: JAX's specs cover float
trees under the unfused names; a rank may fuse its slice after sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import comm
from ..config import ModelConfig
from .expert_parallel import ep_moe_mlp
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

Params = Dict[str, Any]
Spec = Tuple[Optional[str], ...]  # one mesh axis (or None) per dimension

_ATTN_Q = ("wq", "bq", "wo")
_ATTN_KV = ("wk", "bk", "wv", "bv")
_DENSE_MLP = ("w_gate", "w_up", "w_down")
_TIER_FIELDS = ("k_stored", "v_stored", "k_scale", "k_zp", "v_scale",
                "v_zp")


def param_specs(cfg: ModelConfig) -> Params:
    """The spec tree of `models.llama.init_params`'s tree (JAX's
    `param_specs`, a tuple per leaf for its PartitionSpec)."""
    layer = {
        "wq": (None, MODEL_AXIS),        # [H, Hq*D]: heads by column
        "wk": (None, MODEL_AXIS),        # [H, Hkv*D]
        "wv": (None, MODEL_AXIS),
        "wo": (MODEL_AXIS, None),        # [Hq*D, H]: by row (all-reduce)
        "input_norm": (),
        "post_norm": (),
    }
    if cfg.qkv_bias:
        layer.update(bq=(MODEL_AXIS,), bk=(MODEL_AXIS,), bv=(MODEL_AXIS,))
    if cfg.num_experts:
        layer["moe"] = {"gate": (),                        # [H, E]
                        "w_gate": (MODEL_AXIS, None, None),  # [E, H, I]
                        "w_up": (MODEL_AXIS, None, None),
                        "w_down": (MODEL_AXIS, None, None)}  # [E, I, H]
    else:
        layer.update(w_gate=(None, MODEL_AXIS), w_up=(None, MODEL_AXIS),
                     w_down=(MODEL_AXIS, None))
    specs = {"embed": (MODEL_AXIS, None),                  # [V, H]
             "layers": [dict(layer) for _ in range(cfg.num_layers)],
             "final_norm": ()}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, MODEL_AXIS)              # [H, V]
    return specs


def _block(n: int, parts: int, index: int) -> Tuple[int, int]:
    return index * n // parts, (index + 1) * n // parts


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """This rank's slice of a model on a (data, model) mesh: the global
    ranges of the query heads, kv heads, intermediate columns, experts and
    vocabulary it holds (the whole range where that dimension is
    replicated), and the collectives the model code runs over them."""

    mesh: Mesh
    cfg: ModelConfig
    q_heads: Tuple[int, int]
    kv_heads: Tuple[int, int]
    inter: Tuple[int, int]
    experts: Tuple[int, int]
    vocab: Tuple[int, int]

    @property
    def data_size(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def model_group(self):
        return self.mesh.group(MODEL_AXIS)

    @property
    def data_group(self):
        return self.mesh.group(DATA_AXIS)

    def _split(self, rng: Tuple[int, int], total: int) -> bool:
        return rng[1] - rng[0] != total

    @property
    def heads_split(self) -> bool:
        return self._split(self.q_heads, self.cfg.num_heads)

    @property
    def inter_split(self) -> bool:
        return self._split(self.inter, self.cfg.intermediate_size)

    @property
    def experts_split(self) -> bool:
        return self._split(self.experts, self.cfg.num_experts)

    @property
    def vocab_split(self) -> bool:
        return self._split(self.vocab, self.cfg.vocab_size)

    @property
    def head_group(self):
        """The group over which the per-head masses are gathered (None
        when every rank runs every head)."""
        return self.model_group if self.heads_split else None

    def local_config(self, cfg: Optional[ModelConfig] = None) -> ModelConfig:
        """`cfg` (default: the sharded one) at this rank's head, kv-head
        and intermediate counts, for the model's reshapes and buffers; the
        vocabulary and expert counts stay global (the logits are gathered,
        and the router is replicated). Raises ValueError when `cfg`'s
        shapes are not those the tree was sharded for."""
        cfg = self.cfg if cfg is None else cfg
        dims = ("num_heads", "num_kv_heads", "head_dim", "hidden_size",
                "intermediate_size", "vocab_size", "num_experts",
                "num_layers", "qkv_bias", "tie_word_embeddings")
        if any(getattr(cfg, f) != getattr(self.cfg, f) for f in dims):
            raise ValueError("the config's shapes are not those the params "
                             "were sharded for")
        return dataclasses.replace(
            cfg, num_heads=self.q_heads[1] - self.q_heads[0],
            num_kv_heads=self.kv_heads[1] - self.kv_heads[0],
            intermediate_size=self.inter[1] - self.inter[0])

    # -- the data axis -----------------------------------------------------

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This data rank's block of the rows of x (None stays None)."""
        return None if x is None else shard_batch(x, self.mesh)

    def row_start(self, batch: int) -> int:
        """The global index of this data rank's first row of `batch`."""
        return _block(batch, self.data_size, self.mesh.coords[DATA_AXIS])[0]

    def gather_outputs(self, logits: torch.Tensor,
                       stats: Optional[List[Dict[str, torch.Tensor]]] = None
                       ) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
        """The logits and the per-row stats of every data rank's rows, in
        one all-gather over `data` (the batch-wide stats are already
        global). Returns (logits [B, V], stats)."""
        if self.data_group is None:
            return logits, stats
        b = logits.shape[0]
        keys = [(i, key) for i, st in enumerate(stats or [])
                for key, x in st.items() if x.dim() and x.shape[0] == b]
        parts = comm.all_gather_tensors(
            [logits] + [stats[i][key] for i, key in keys], self.data_group)
        logits = torch.cat([p[0] for p in parts])
        if stats is None:
            return logits, None
        stats = [dict(st) for st in stats]
        for j, (i, key) in enumerate(keys, start=1):
            stats[i][key] = torch.cat([p[j] for p in parts])
        return logits, stats

    # -- the model axis ----------------------------------------------------

    def reduce(self, partial: torch.Tensor, dtype) -> torch.Tensor:
        """The float32 SUM of every model rank's partial product, rounded
        once to `dtype` (the gradient passes to each partial as it is)."""
        return comm.reduce_sum(partial.float(), self.model_group).to(dtype)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """x, the input of column-parallel products (fused QKV, gate/up,
        the vocab-split head): as it is, its gradient summed over `model`
        in the backward."""
        return comm.enter_split(x, self.model_group)

    def embed(self, embed: torch.Tensor, ids: torch.Tensor,
              dtype) -> torch.Tensor:
        """Embedding rows of `ids` from the vocab-sharded table: each rank
        looks up the ids in its range (zeros elsewhere) and one SUM
        all-reduce assembles them, exactly."""
        lo, hi = self.vocab
        local = ids.long() - lo
        here = (local >= 0) & (local < hi - lo)
        rows = embed[torch.clamp(local, 0, hi - lo - 1)].float()
        rows = torch.where(here[..., None], rows,
                           torch.zeros((), device=rows.device))
        return comm.reduce_sum(rows, self.model_group).to(dtype)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """[..., V/m] logits of every model rank, concatenated: [..., V]
        (the gradient: this rank's block of the vocabulary)."""
        return comm.gather_split(logits.contiguous(), logits.dim() - 1,
                                 self.model_group)

    # -- training ------------------------------------------------------------

    def leaf_kinds(self, tree: Params) -> List["LeafKind"]:
        """How each tensor of this rank's tree (in the order
        `models.train` takes them: dict values in order, list items in
        order) is held, for the gradient sums and the clip's norm
        (`sync_grads`, `grad_norm_of`)."""
        m, coord = self.mesh.shape[MODEL_AXIS], self.mesh.coords[MODEL_AXIS]
        cfg, d = self.cfg, self.cfg.head_dim
        n_rep = cfg.num_heads // cfg.num_kv_heads
        # kv heads held by several model ranks, each using them for part of
        # its query heads (one kv head for all, Gemma-style, or groups cut
        # across ranks): their gradients are partial on every holder.
        kv_shared = self.heads_split and cfg.num_kv_heads % m != 0
        out = []
        for name, in_moe, _ in _named_leaves(tree):
            if in_moe:
                if not self.experts_split:
                    out.append(LeafKind("replicated"))
                elif name == "gate":
                    # The replicated router weighs only this rank's
                    # experts' rows.
                    out.append(LeafKind("partial", owner=coord == 0))
                else:
                    out.append(LeafKind("split"))
                continue
            if name in _ATTN_KV and kv_shared:
                lo, hi = self.kv_heads
                out.append(LeafKind(
                    "partial", owner=self.q_heads[0] == lo * n_rep,
                    span=(lo * d, hi * d, cfg.num_kv_heads * d)))
                continue
            split = (self.heads_split if name in _ATTN_Q + _ATTN_KV
                     else self.inter_split if name in _DENSE_MLP
                     else self.vocab_split if name in ("embed", "lm_head")
                     else False)
            out.append(LeafKind("split" if split else "replicated"))
        return out

    def sync_grads(self, tensors: List[torch.Tensor],
                   kinds: List["LeafKind"]) -> None:
        """After the backward, in place: each partial gradient (`leaf_kinds`)
        summed over `model` (placed at its columns of the whole leaf, so
        the ranks that hold it add theirs), then every gradient summed over
        `data` (each data rank's loss covered its own rows). One float32
        all-reduce each."""
        parts = [(t, k) for t, k in zip(tensors, kinds)
                 if k.kind == "partial"]
        if parts and self.model_group is not None:
            padded = []
            for t, k in parts:
                g = t.grad.float()
                if k.span is not None:
                    lo, hi, total = k.span
                    g = torch.nn.functional.pad(g, (lo, total - hi))
                padded.append(g)
            summed = _all_reduce_flat(padded, self.model_group)
            for (t, k), g in zip(parts, summed):
                if k.span is not None:
                    g = g[..., k.span[0]:k.span[1]]
                t.grad.copy_(g)
        if self.data_group is not None:
            grads = [t.grad for t in tensors]
            for g, s in zip(grads, _all_reduce_flat(
                    [g.float() for g in grads], self.data_group)):
                g.copy_(s)

    def grad_norm_of(self, kinds: List["LeafKind"]):
        """`Optimizer.step`'s `norm_of` over this rank's per-tensor
        gradient norms: the whole model's global norm. A tensor split over
        `model` adds its squares over the model ranks; a partial one (its
        gradient summed by `sync_grads`) once, by one of its holders; a
        replicated one once, on every rank. The same on every rank."""
        split = [k.kind == "split" or (k.kind == "partial" and k.owner)
                 for k in kinds]
        rep = [k.kind == "replicated" for k in kinds]

        def norm_of(norms: torch.Tensor) -> torch.Tensor:
            sq = norms * norms
            w_split = torch.tensor(split, device=sq.device)
            w_rep = torch.tensor(rep, device=sq.device)
            total = comm.all_reduce_sum(
                torch.where(w_split, sq, 0.0).sum()[None], self.model_group)
            return torch.sqrt(total[0] + torch.where(w_rep, sq, 0.0).sum())

        return norm_of

    def moe(self, moe: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
        """The expert-parallel MoE MLP over this rank's experts (lossless
        capacity), summed over `model`."""
        return ep_moe_mlp(moe, x, cfg, self.mesh)

    def finish(self, logits, state, stats, batch: int):
        """A prefill's results: the logits and per-row stats gathered over
        `data` (`gather_outputs`), the state checked
        (`constrain_decode_state`)."""
        logits, stats = self.gather_outputs(logits, stats)
        return logits, constrain_decode_state(state, self, batch), stats

    def wrap(self, tree: Params) -> "ShardedParams":
        return ShardedParams(tree, self)

    def rows_whole(self) -> "ShardLayout":
        """This layout with the data axis folded away: every rank takes
        every row of a batch (the weights stay split over `model`, the
        collectives over `data` issue nothing). The sharded serving
        engine's admission prefill runs on it, so that a batch smaller
        than the data axis needs no padding and its batch-wide stats are
        the whole batch's."""
        if self.data_size == 1:
            return self
        m = self.mesh
        return dataclasses.replace(self, mesh=Mesh(
            axis_names=m.axis_names, shape={**m.shape, DATA_AXIS: 1},
            coords={**m.coords, DATA_AXIS: 0},
            groups={**m.groups, DATA_AXIS: None}))


@dataclasses.dataclass(frozen=True)
class LeafKind:
    """How a rank holds one tensor of its tree: "split" (its own slice of
    a leaf split over `model`), "replicated" (the whole leaf, used whole:
    the same gradient on every rank) or "partial" (a leaf held by several
    model ranks, each using it for part of the model: each holds part of
    its gradient). A partial leaf's `span` is (first, end, whole) of its
    last dimension within the whole leaf (None: whole), and `owner` says
    whether this rank adds its squares to the global norm."""

    kind: str
    owner: bool = False
    span: Optional[Tuple[int, int, int]] = None


def _named_leaves(tree, name: str = "", in_moe: bool = False):
    """(name, whether it lies in a "moe" dict, tensor) of every leaf, in
    the order `models.train` takes the tensors."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _named_leaves(value, key, in_moe or key == "moe")
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _named_leaves(value, name, in_moe)
    else:
        yield name, in_moe, tree


def _all_reduce_flat(tensors: List[torch.Tensor], group
                     ) -> List[torch.Tensor]:
    """The SUM over `group` of float32 tensors of any shapes, in one
    all-reduce of their concatenation."""
    flat = comm.all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]),
                               group)
    return [x.view_as(t) for x, t in zip(
        torch.split(flat, [t.numel() for t in tensors]), tensors)]


class ShardedParams(dict):
    """A rank's params tree (a plain dict of its slices) carrying its
    `ShardLayout`, which the model's prefill and decode functions read."""

    def __init__(self, tree: Params, layout: ShardLayout):
        super().__init__(tree)
        self.layout = layout


def shard_layout(cfg: ModelConfig, mesh: Mesh) -> ShardLayout:
    """This rank's `ShardLayout` of a `cfg` model on `mesh`: each model
    dimension split in contiguous blocks by the rank's `model`
    coordinate where the axis divides it (in whole heads for the
    attention), else whole."""
    m, r = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    n_rep = hq // hkv
    q = kv = None
    if m > 1 and hq % m == 0:
        q = _block(hq, m, r)
        kv = (q[0] // n_rep, (q[1] - 1) // n_rep + 1)
        # Local GQA must map local q head i to local kv head i // n_rep':
        # contiguous whole groups, or one kv head for all of them.
        if not (hkv % m == 0 or n_rep % (hq // m) == 0):
            q = kv = None
    if q is None:
        q, kv = (0, hq), (0, hkv)

    def block(n: int) -> Tuple[int, int]:
        return _block(n, m, r) if n and n % m == 0 else (0, n)

    return ShardLayout(mesh=mesh, cfg=cfg, q_heads=q, kv_heads=kv,
                       inter=block(cfg.intermediate_size),
                       experts=block(cfg.num_experts),
                       vocab=block(cfg.vocab_size))


def _leaf_range(name: str, lay: ShardLayout) -> Tuple[int, int]:
    """The range a sharded leaf keeps along its `model` dimension."""
    d = lay.cfg.head_dim
    if name in _ATTN_Q:
        return lay.q_heads[0] * d, lay.q_heads[1] * d
    if name in _ATTN_KV:
        return lay.kv_heads[0] * d, lay.kv_heads[1] * d
    if name in _DENSE_MLP:
        return lay.inter
    if name in ("embed", "lm_head"):
        return lay.vocab
    raise KeyError(name)


def _slice(x, spec: Spec, name: str, lay: ShardLayout, in_moe: bool):
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"shard_params takes float trees: {name} is a "
                         f"{type(x).__name__} (quantized trees are not "
                         f"sharded, as in the JAX package)")
    if MODEL_AXIS not in spec:
        return x
    dim = spec.index(MODEL_AXIS)
    lo, hi = lay.experts if in_moe else _leaf_range(name, lay)
    if hi - lo == x.shape[dim]:
        return x
    # A copy of its own: a block of leading rows would be a contiguous
    # view, which keeps the whole tensor alive.
    return x.narrow(dim, lo, hi - lo).clone(
        memory_format=torch.contiguous_format)


def shard_params(params: Params, mesh: Mesh,
                 cfg: ModelConfig) -> ShardedParams:
    """This rank's slice of every leaf of a float params tree, by its
    coordinates on `mesh` and `param_specs` (whole heads; a dimension the
    axis does not divide stays whole). The result carries its layout, so
    the model's prefill and decode functions run sharded on it. Raises
    ValueError for a fused tree (`wqkv`, `w_gateup`: fuse after sharding)
    or a quantized one."""
    lay = shard_layout(cfg, mesh)
    specs = param_specs(cfg)
    out = {}
    for key, value in params.items():
        if key == "layers":
            continue
        if key not in specs:
            raise ValueError(f"shard_params: no spec for {key!r}")
        out[key] = _slice(value, specs[key], key, lay, False)
    out["layers"] = []
    for layer, lspec in zip(params["layers"], specs["layers"]):
        fused = {"wqkv", "bqkv", "w_gateup"} & set(layer)
        if fused:
            raise ValueError(f"shard_params takes the unfused tree (JAX's "
                             f"specs address wq/wk/wv, w_gate/w_up), not "
                             f"{sorted(fused)}: fuse each rank's slice "
                             f"after sharding")
        if set(layer) != set(lspec):
            raise ValueError(f"shard_params: layer keys {sorted(layer)} "
                             f"are not the spec's {sorted(lspec)}")
        lo = {}
        for name, value in layer.items():
            if name == "moe":
                lo[name] = {n: _slice(v, lspec[name][n], n, lay, True)
                            for n, v in value.items()}
            else:
                lo[name] = _slice(value, lspec[name], name, lay, False)
        out["layers"].append(lo)
    return ShardedParams(out, lay)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data rank's rows of x (ids [B, S], lengths [B], tokens [B]):
    JAX's `data_sharding` placement, one block of B / data rows a rank.
    Raises ValueError when the data axis does not divide B."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the {n} "
                         f"data ranks")
    lo, hi = _block(x.shape[0], n, mesh.coords[DATA_AXIS])
    return x[lo:hi]



def tier_cache_specs() -> Dict[str, Spec]:
    """Specs of one TierCache's tensors: kv heads on `model`, batch on
    `data`; positions and validity replicated over `model`."""
    four = (DATA_AXIS, None, MODEL_AXIS, None)
    return {**{f: four for f in _TIER_FIELDS},
            "positions": (DATA_AXIS, None), "valid": (DATA_AXIS, None)}


def constrain_decode_state(state, layout: ShardLayout, batch: int):
    """Checks that a decode state is laid out as the specs say for this
    rank: every tier, ring and decode-pool tensor holds this data rank's
    rows (batch / data) and, on its kv-head axis, this rank's kv heads
    (all of them where they are replicated); positions and validity the
    rank's rows. Raises ValueError otherwise; returns the state."""
    rows = batch // layout.data_size
    kv = layout.kv_heads[1] - layout.kv_heads[0]
    four = (DATA_AXIS, None, MODEL_AXIS, None)
    want = {DATA_AXIS: rows, MODEL_AXIS: kv}

    def check(t: torch.Tensor, spec: Spec, what: str) -> None:
        for dim, axis in enumerate(spec):
            if axis is not None and t.shape[dim] != want[axis]:
                raise ValueError(f"decode state {what}: shape "
                                 f"{tuple(t.shape)}, dimension {dim} on "
                                 f"{axis} should be {want[axis]}")

    specs = tier_cache_specs()
    for li, cache in enumerate(state.caches):
        for t in cache.tiers:
            for f, spec in specs.items():
                check(getattr(t, f), spec, f"layer {li} {f}")
    for li, r in enumerate(state.recents):
        check(r.k, four, f"layer {li} ring k")
        check(r.v, four, f"layer {li} ring v")
        check(r.positions, (DATA_AXIS, None), f"layer {li} ring positions")
    for li, p in enumerate(state.pools):
        if p is not None:
            for f in _TIER_FIELDS:
                check(getattr(p, f), four, f"layer {li} pool {f}")
            check(p.positions, (DATA_AXIS, None), f"layer {li} pool "
                                                  f"positions")
    check(state.position, (DATA_AXIS,), "position")
    return state
