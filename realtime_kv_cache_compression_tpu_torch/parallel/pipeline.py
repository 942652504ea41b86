"""Pipeline parallelism over a `pipe` axis of ranks.

Port of the JAX package's `parallel/pipeline.py`, one process per stage:
rank r of a `create_pipe_mesh(n)` mesh is stage r and holds the layers
r·L/n .. (r+1)·L/n - 1 (L must be a multiple of n, else ValueError).
Activations travel stage to stage as point-to-point hops over the axis's
group (`comm.send_to` / `comm.recv_from`), and every rank issues every hop
in one fixed order, so the ranks never wait on each other in a cycle. Two
forms, as in JAX:

1. `pipeline_lm_loss` / `pipeline_train_step`: a GPipe schedule for
   training. `stack_pipeline_params` keeps a rank's layers stacked into
   leading-[L/n] tensors (embed, final_norm and lm_head whole on every
   rank, as JAX replicates them). Microbatches stream through
   n_microbatches + n_stages - 1 ticks; in tick t stage s runs
   microbatch t - s, where there is one. The backward is an explicit
   reverse schedule: the last stage starts from its microbatch losses,
   and each stage sends its input's gradient back to the stage before
   it. The replicated leaves' gradients are summed over the axis, and the
   optimizer's global-norm clip sees the norm of the whole model (the
   stages' squared norms summed). The stage body is the plain prompt-mass
   attention: no kernel of the port runs in training, as in
   `models/train.py`: the stage runs the trainer's own layer loop
   (`llama.forward_layers`) and cross-entropy (`train.token_nll`).

2. `PipelineInference`: compressed prefill and greedy decode with each
   stage's layers on its own rank, through `llama.prefill_layers_compressed`
   and `llama.decode_layers_step` at each layer's exact cache shapes (the
   tier capacities follow absolute depth). Stage 0 embeds, the last stage
   holds the final norm and head; the logits and each step's tokens are
   broadcast from it, and the per-layer stats gathered, so every rank
   returns the same results. K1 (mode (a)) and K2 run in each stage as in
   the whole-model functions. Decode crosses every stage per token: serving
   should prefer tensor and sequence parallelism (`sharding.py`,
   `seq_parallel.py`), as the JAX docstring says.

Without a mesh (mesh=None) one rank is the whole pipeline and no
collective is issued.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import comm
from ..compression.kv_cache import model_dtype
from ..config import CompressionConfig, ModelConfig
from ..models import llama
from ..models.train import Optimizer, token_nll
from .mesh import PIPE_AXIS, Mesh, create_pipe_mesh  # noqa: F401

Params = Dict[str, Any]
_HEAD_KEYS = ("embed", "final_norm", "lm_head")


def _place(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(this rank's stage, the stage count) on `mesh`'s pipe axis."""
    if mesh is None:
        return 0, 1
    return mesh.coords[PIPE_AXIS], mesh.shape[PIPE_AXIS]


def _stage_of(mesh: Optional[Mesh], num_layers: int) -> Tuple[int, int, int]:
    """(this rank's stage, the stage count, layers a stage) on `mesh`'s
    pipe axis (one stage without a mesh). Raises ValueError when the
    stages do not divide the layers."""
    stage, n = _place(mesh)
    if num_layers % n:
        raise ValueError(f"{num_layers} layers not divisible by {n} "
                         f"pipeline stages")
    return stage, n, num_layers // n


def _group(mesh: Optional[Mesh]):
    return None if mesh is None else mesh.group(PIPE_AXIS)


# ---------------------------------------------------------------------------
# GPipe training
# ---------------------------------------------------------------------------

def _stack(layers: List[Params]) -> Params:
    return {k: (_stack([layer[k] for layer in layers])
                if isinstance(v, dict)
                else torch.stack([layer[k] for layer in layers]))
            for k, v in layers[0].items()}


def _index(stacked: Params, i: int) -> Params:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _leaves(tree: Params, prefix: Tuple[str, ...] = ()):
    """(path, tensor) of every leaf of a nested dict, in a fixed order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def stack_pipeline_params(params: Params, mesh: Optional[Mesh]) -> Params:
    """This rank's stage of a float params tree: its layers stacked into
    leading-[L/n] tensors under "layers" (layer i of the stage at index
    i), the other leaves (embed, final_norm, lm_head) copied whole. The
    result owns its tensors, so training it leaves `params` as it was.
    Raises ValueError when the stages do not divide the layers."""
    stage, _, per = _stage_of(mesh, len(params["layers"]))
    out = {k: v.clone() for k, v in params.items() if k != "layers"}
    out["layers"] = _stack(params["layers"][stage * per:(stage + 1) * per])
    return out


def unstack_pipeline_params(stacked: Params,
                            mesh: Optional[Mesh] = None) -> Params:
    """The inverse of `stack_pipeline_params`: every stage's stacked layers
    gathered over the pipe axis (one all-gather) and split back into the
    whole model's list of per-layer dicts, on every rank, in tensors of
    its own. Without a mesh the stacked layers are taken as the whole
    model's."""
    paths, tensors = zip(*_leaves(stacked["layers"]))
    parts = comm.all_gather_tensors([t.detach() for t in tensors],
                                    _group(mesh))
    whole = [torch.cat([p[i] for p in parts]) for i in range(len(tensors))]
    layers = []
    for li in range(whole[0].shape[0]):
        layer: Params = {}
        for path, t in zip(paths, whole):
            node = layer
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t[li]
        layers.append(layer)
    out = {k: v.detach().clone() for k, v in stacked.items()
           if k != "layers"}
    out["layers"] = layers
    return out


def _gpipe(stacked: Params, input_ids: torch.Tensor, cfg: ModelConfig,
           mesh: Optional[Mesh], n_microbatches: int, train: bool):
    """The GPipe forward over n_microbatches + n_stages - 1 ticks. Returns
    (the mean of the microbatch means, the same on every rank; per
    microbatch this rank ran, (its received input or None on stage 0,
    its output, its loss on the last stage or None)), the graphs kept
    when `train`."""
    group = _group(mesh)
    stage, n = _place(mesh)
    b, s = input_ids.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} "
                         f"microbatches")
    mb = b // n_microbatches
    dev = stacked["final_norm"].device
    ids = input_ids.to(dev).reshape(n_microbatches, mb, s)
    dtype = model_dtype(cfg)
    positions = torch.arange(s, device=dev)[None].expand(mb, s)
    cos, sin = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                                 cfg.rope_scaling)
    per = next(_leaves(stacked["layers"]))[1].shape[0]
    layers = [_index(stacked["layers"], i) for i in range(per)]
    records = []
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for tick in range(n_microbatches + n - 1):
        m = tick - stage
        if not 0 <= m < n_microbatches:
            continue  # a bubble: this stage has no microbatch in this tick
        x_in = None
        if stage == 0:
            x = llama._embed_lookup(stacked["embed"], ids[m], dtype, cfg)
        else:
            x = comm.recv_from(torch.empty((mb, s, cfg.hidden_size),
                                           dtype=dtype, device=dev),
                               stage - 1, group)
            x_in = x.requires_grad_(train)
        y = llama.forward_layers(layers, x, cos, sin, cfg, use_flash=False)
        nll = None
        if stage < n - 1:
            comm.send_to(y.detach(), stage + 1, group)
        else:
            nll = token_nll(llama.logits_from_hidden(stacked, y, cfg),
                            ids[m]).mean()
            loss_acc = loss_acc + nll.detach()
        records.append((x_in, y, nll))
    loss = comm.all_reduce_sum(loss_acc, group) / n_microbatches
    return loss, records


def pipeline_lm_loss(stacked: Params, input_ids: torch.Tensor,
                     cfg: ModelConfig, mesh: Optional[Mesh],
                     n_microbatches: int) -> torch.Tensor:
    """Mean next-token cross-entropy through the pipeline: the mean of the
    microbatch means (equal to `train.lm_loss` on the whole batch, since
    the microbatches are of equal size), a float32 scalar on every rank.
    The bubble fraction is (n_stages - 1) / (n_microbatches + n_stages -
    1). No gradient is kept (`pipeline_train_step` trains)."""
    with torch.no_grad():
        return _gpipe(stacked, input_ids, cfg, mesh, n_microbatches,
                      train=False)[0]


def _pipe_norm(optimizer: Optimizer, stacked: Params, group
               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The global gradient norm of the whole pipelined model from this
    rank's per-tensor norms: the stage's layer norms squared and summed
    over the pipe axis, plus the replicated leaves' (the same on every
    rank after their gradients were summed) once."""
    layer_ids = {id(t) for _, t in _leaves(stacked["layers"])}
    local = torch.tensor([id(t) in layer_ids for t in optimizer.tensors])

    def norm(norms: torch.Tensor) -> torch.Tensor:
        sq = norms * norms
        mask = local.to(sq.device)
        layers = comm.all_reduce_sum(torch.where(mask, sq, 0.0).sum(), group)
        return torch.sqrt(layers + torch.where(mask, 0.0, sq).sum())

    return norm


def pipeline_train_step(stacked: Params, optimizer: Optimizer,
                        input_ids: torch.Tensor, cfg: ModelConfig,
                        mesh: Optional[Mesh],
                        n_microbatches: int) -> torch.Tensor:
    """One pipelined training step on this rank's `stacked` stage (from
    `stack_pipeline_params`) with `optimizer` from
    `train.make_optimizer(stacked, ...)`: the GPipe forward, the reverse
    schedule (each stage backpropagates its microbatches in order from the
    gradient the next stage sends, and sends its input's gradient to the
    stage before), the replicated leaves' gradients summed over the pipe
    axis, then the clip at the whole model's global norm and the AdamW
    update, in place. Returns the loss (a device scalar, the same on every
    rank)."""
    group = _group(mesh)
    stage, n = _place(mesh)
    optimizer.zero_grad()
    loss, records = _gpipe(stacked, input_ids, cfg, mesh, n_microbatches,
                           train=True)
    for x_in, y, nll in records:
        if stage == n - 1:
            (nll / n_microbatches).backward()
        else:
            y.backward(comm.recv_from(torch.empty_like(y), stage + 1, group))
        if stage > 0:
            comm.send_to(x_in.grad, stage - 1, group)
    for key in _HEAD_KEYS:
        if key in stacked:
            t = stacked[key]
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            t.grad = comm.all_reduce_sum(g.float(), group).to(t.dtype)
    optimizer.step(norm_of=_pipe_norm(optimizer, stacked, group))
    return loss


# ---------------------------------------------------------------------------
# Compressed inference, one stage a rank
# ---------------------------------------------------------------------------

class PipelineInference:
    """Compressed prefill + greedy decode with the layers split over the
    ranks of a pipe mesh (this rank runs its stage).

    Every rank constructs it with the same whole float `params` (each keeps
    references to its stage's layers only, plus the embedding on stage 0
    and the final norm and head on the last stage) and calls `prefill` and
    `decode` with the same arguments. use_flash / use_fused None: K1 / K2
    on CUDA params. Raises ValueError when the stages do not divide the
    layers.
    """

    def __init__(self, params: Params, cfg: ModelConfig,
                 ccfg: CompressionConfig, mesh: Optional[Mesh] = None,
                 max_decode_len: int = 128,
                 use_flash: Optional[bool] = None,
                 use_fused: Optional[bool] = None):
        self.stage, self.n_stages, self.per = _stage_of(mesh, cfg.num_layers)
        self.cfg, self.ccfg = cfg, ccfg
        self.group = _group(mesh)
        self.max_decode_len = max_decode_len
        lo = self.stage * self.per
        self.layers = list(params["layers"][lo:lo + self.per])
        self.layer_offset = lo
        self.device = params["final_norm"].device
        self.use_flash = (self.device.type == "cuda" if use_flash is None
                          else use_flash)
        self.use_fused = (self.device.type == "cuda" if use_fused is None
                          else use_fused)
        self.embed = params["embed"] if self.stage == 0 else None
        self.head = None
        if self.is_last:
            self.head = {k: params[k] for k in _HEAD_KEYS if k in params}
        self._state: Optional[llama.DecodeState] = None

    @property
    def is_last(self) -> bool:
        return self.stage == self.n_stages - 1

    def _receive(self, shape) -> torch.Tensor:
        return comm.recv_from(torch.empty(shape, dtype=model_dtype(self.cfg),
                                          device=self.device),
                              self.stage - 1, self.group)

    def _hop(self, shape, ids: torch.Tensor) -> torch.Tensor:
        """The hidden states entering this stage: stage 0 embeds `ids`, a
        later stage receives `shape` from the stage before it."""
        if self.stage == 0:
            return llama._embed_lookup(self.embed, ids, model_dtype(self.cfg),
                                       self.cfg)
        return self._receive(shape)

    def _pass_on(self, h: torch.Tensor) -> None:
        if not self.is_last:
            comm.send_to(h, self.stage + 1, self.group)

    def _gather_stats(self, stats: List[Dict[str, torch.Tensor]]
                      ) -> List[Dict[str, torch.Tensor]]:
        """Every stage's per-layer stats, in layer order, on every rank."""
        if self.group is None:
            return stats
        keys = sorted(stats[0])
        flat = [torch.as_tensor(st[k], device=self.device)
                for st in stats for k in keys]
        parts = comm.all_gather_tensors(flat, self.group)
        nk = len(keys)
        return [dict(zip(keys, part[li * nk:(li + 1) * nk]))
                for part in parts for li in range(self.per)]

    def prefill(self, input_ids: torch.Tensor):
        """Compressed prefill through every stage. input_ids: [B, S], the
        same on every rank. Returns (last-position logits [B, V],
        per-layer stats of all L layers), the same on every rank; the
        stage's decode state stays here for `decode`."""
        cfg, ccfg = self.cfg, self.ccfg
        ids = input_ids.to(self.device)
        b, s = ids.shape
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        cos, sin = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                                     cfg.rope_scaling)
        h = self._hop((b, s, cfg.hidden_size), ids)
        h, caches, recents, pools, stats = llama.prefill_layers_compressed(
            self.layers, self.layer_offset, h, positions, cos, sin,
            ccfg.prompt_length(s), cfg, ccfg, self.max_decode_len,
            use_flash=self.use_flash)
        self._pass_on(h)
        self._state = llama.DecodeState(
            caches=tuple(caches), recents=tuple(recents),
            position=torch.full((b,), s, dtype=torch.int32,
                                device=self.device),
            pools=tuple(pools))
        logits = torch.empty((b, cfg.vocab_size), dtype=model_dtype(cfg),
                             device=self.device)
        if self.is_last:
            logits = llama.logits_from_hidden(self.head, h[:, -1],
                                              cfg).to(logits.dtype)
        logits = comm.broadcast(logits, self.n_stages - 1, self.group)
        return logits, self._gather_stats(stats)

    def decode(self, first_token: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Greedy decode after `prefill`: each step crosses every stage,
        and the last stage's argmax is broadcast to every rank (stage 0
        embeds it next). first_token: [B], the same on every rank. Returns
        the tokens [B, n_steps] on every rank."""
        cfg, ccfg, st = self.cfg, self.ccfg, self._state
        if st is None:
            raise ValueError("decode before prefill")
        tok = first_token.to(self.device).long()
        b = tok.shape[0]
        pooled = bool(st.pools) and st.pools[0] is not None
        outs = []
        for _ in range(n_steps):
            q_pos = st.position[:, None]
            cos, sin = llama.rope_tables(q_pos, cfg.head_dim, cfg.rope_theta,
                                         cfg.rope_scaling)
            flush, ring_fill = llama.ring_fill_step(
                st.ring_fill, st.recents[0].capacity, pooled)
            h = self._hop((b, 1, cfg.hidden_size), tok)
            if self.stage == 0:
                h = h[:, None]
            h = llama.decode_layers_step(
                self.layers, h, st.caches, st.recents, st.pools, q_pos, cos,
                sin, cfg, ccfg, use_fused=self.use_fused, flush=flush)
            self._pass_on(h)
            if self.is_last:
                tok = torch.argmax(
                    llama.logits_from_hidden(self.head, h[:, 0], cfg), -1)
            tok = comm.broadcast(tok, self.n_stages - 1, self.group)
            outs.append(tok)
            st = dataclasses.replace(st, position=st.position + 1,
                                     ring_fill=ring_fill)
        self._state = st
        if not outs:
            return tok.new_zeros((b, 0))
        return torch.stack(outs, dim=1)
