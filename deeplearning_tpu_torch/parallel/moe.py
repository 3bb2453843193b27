"""Mixture-of-experts MLP with expert parallelism — the port of
``deeplearning_tpu/parallel/moe.py``.

Same routing as JAX's ``MoEMlp``, written in plain torch (JAX computes it
outside any Pallas kernel): a float32 router, top-k argmax rounds, a
capacity of ``max(int(t / e * capacity_factor * top_k), 1)`` slots an
expert, each token's slot its rank among the tokens that chose its expert
in token order, offset by the slots earlier rounds used, and tokens past
the capacity dropped (they pass as zeros; the residual outside carries
them). Every shape is static: no ``nonzero``, no ``masked_select``, no
``.item()``, so the routing never waits for the host.

``ExpertMlp`` keeps JAX's batched layout and names (``fc1_kernel (E, d,
h)``, ``fc1_bias (E, h)``, ``fc2_kernel (E, h, o)``, ``fc2_bias (E,
o)``), so ``utils/convert.from_flax_params`` passes them through
untransposed and ``MOE_RULES`` splits dim 0 over ``expert``. Its GELU is
tanh-approximate whatever ``core.numerics`` says, and its weights are
cast to the activation dtype, as in JAX.

The dispatch and the combine are ``index_select`` gathers: the slot
table is filled by a scatter whose dropped tokens all write a dummy row
``e`` that nothing reads (the kept slots are unique), and the backward of
either gather is an ``index_add_``, not a sorted ``index_put_``.

What JAX ``sow``s (``losses/moe_aux`` from the Swin block, the three
``moe_metrics`` from here) the port collects per forward inside
``collect_moe()``: a forward outside it keeps nothing, nothing survives
from one forward into the next, nothing syncs with the host and the aux
loss stays in the autograd graph. ``MoEMlp`` returns ``(out, aux)``; aux
is None under ``torch.no_grad`` outside ``collect_moe()`` (the serve
engine), which then runs no launch for it; the metrics are computed only
inside ``collect_moe()``.

Expert parallelism: once ``bind_expert_parallel`` sets a ``MoEMlp``'s
``expert_group`` (n ranks), its ``experts`` hold this rank's slice of
the experts, [r E / n, (r + 1) E / n). The ranks of one expert group see
the same tokens (the batch is split over data x fsdp only) and route
them alike; each rank runs its own experts on every slot of those
experts, and the combine all-gathers the expert outputs over the group.
The gather's backward hands each rank its own experts' slice of the
gradient (every rank computes the same loss, so a sum would count it n
times), and the tokens enter the local dispatch through
``collectives.copy_to_model``, whose backward sums the local experts'
input gradients over the group.

Over several data x fsdp ranks (``token_group``, set by the same
binding) the routing is JAX's over the global batch: the capacity is the
global batch's, a token's capacity rank counts the tokens of the earlier
ranks (an all-gather of E counts a round), and the load-balance loss and
the metrics take their means over every rank's tokens. Each rank still
dispatches only its own tokens, into a table of ``min(capacity, t ·
top_k)`` slots an expert.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mesh import EXPERT_AXIS, Mesh
from .sharding import NamedSharding, P, Rules

__all__ = ["MOE_RULES", "load_balance_loss", "ExpertMlp", "MoEMlp",
           "collect_moe", "sow", "bind_expert_parallel"]

# expert-major leading axis, as JAX's rules (the port keeps the layout)
MOE_RULES: Rules = (
    (r"experts/(fc1|fc2)_kernel$", P(EXPERT_AXIS, None, None)),
    (r"experts/(fc1|fc2)_bias$", P(EXPERT_AXIS, None)),
)

_LOCAL = threading.local()


@contextlib.contextmanager
def collect_moe() -> Iterator[Dict[str, List]]:
    """Collect what the MoE layers of the forwards run inside the block
    report: ``{"losses": [aux, ...], "moe_metrics": [{"drop_rate",
    "capacity_util", "max_expert_load"}, ...]}`` (device tensors, one
    entry a layer, in the order the layers run)."""
    sown: Dict[str, List] = {"losses": [], "moe_metrics": []}
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    stack.append(sown)
    try:
        yield sown
    finally:
        stack.pop()


def _collector() -> Optional[Dict[str, List]]:
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


def sow(kind: str, value) -> None:
    """Record ``value`` under ``kind`` in the innermost ``collect_moe()``;
    nothing outside one."""
    sown = _collector()
    if sown is not None:
        sown[kind].append(value)


def load_balance_loss(router_probs: torch.Tensor, expert_mask: torch.Tensor,
                      group=None) -> torch.Tensor:
    """Switch-style aux loss: E · dot(mean prob per expert, fraction of
    tokens per expert), over the (T, E) probabilities and mask. With a
    ``group`` the means cover every rank's tokens: the mask's sums are
    all-reduced, and the probabilities' differentiably, so each rank's
    router gradient carries its tokens' share."""
    density, proxy = expert_mask.float().sum(0), router_probs.sum(0)
    t = router_probs.shape[0]
    if group is not None:
        from .collectives import all_reduce, all_reduce_autograd
        density = all_reduce(density, group)
        proxy = all_reduce_autograd(proxy, group)
        t *= _world(group)
    return router_probs.shape[-1] * torch.sum((density / t) * (proxy / t))


def _lecun_normal_batched_(w: torch.Tensor,
                           generator: torch.Generator) -> None:
    """flax's lecun_normal on a batched (E, in, out) kernel: its fan-in
    counts the leading axis as a receptive field, E · in."""
    std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class ExpertMlp(nn.Module):
    """E parallel MLPs as batched parameters (leading E axis, the one
    ``MOE_RULES`` splits). x: (E, C, D) -> (E, C, out_dim)."""

    def __init__(self, num_experts: int, dim: int, hidden: int,
                 out_dim: int):
        super().__init__()
        self.fc1_kernel = nn.Parameter(torch.zeros(num_experts, dim, hidden))
        self.fc1_bias = nn.Parameter(torch.zeros(num_experts, hidden))
        self.fc2_kernel = nn.Parameter(torch.zeros(num_experts, hidden,
                                                   out_dim))
        self.fc2_bias = nn.Parameter(torch.zeros(num_experts, out_dim))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal_batched_(self.fc1_kernel, generator)
        _lecun_normal_batched_(self.fc2_kernel, generator)
        nn.init.zeros_(self.fc1_bias)
        nn.init.zeros_(self.fc2_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = torch.bmm(x, self.fc1_kernel.to(dt)) + self.fc1_bias[:, None].to(dt)
        y = F.gelu(y, approximate="tanh")
        return torch.bmm(y, self.fc2_kernel.to(dt)) \
            + self.fc2_bias[:, None].to(dt)


class MoEMlp(nn.Module):
    """Drop-in MLP with top-k capacity-limited routing. x: (B, N, D) ->
    ``(out, aux)``: out (B, N, D) in x's dtype, aux the weighted
    load-balance loss (None under ``torch.no_grad`` outside
    ``collect_moe()``)."""

    def __init__(self, dim: int, num_experts: int = 8, top_k: int = 1,
                 capacity_factor: float = 1.25, hidden_ratio: float = 4.0,
                 aux_weight: float = 0.01, drop: float = 0.0):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.aux_weight = capacity_factor, aux_weight
        self.drop = drop
        self.expert_group = None
        self.token_group = None
        self.router = nn.Linear(dim, num_experts)
        self.experts = ExpertMlp(num_experts, dim, int(dim * hidden_ratio),
                                 dim)

    def ep_layout(self, n: int) -> Optional[Dict[str, int]]:
        """The split over n expert ranks: every expert leaf by its dim 0;
        None when n does not divide the experts."""
        if self.num_experts % n:
            return None
        return {f"experts.{k}": 0 for k in ("fc1_kernel", "fc1_bias",
                                            "fc2_kernel", "fc2_bias")}

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        from ..models.classification.vit import dropout
        b, n, d = x.shape
        t = b * n
        tokens = x.reshape(t, d)
        e, k_top = self.num_experts, self.top_k
        tg = self.token_group
        n_tok = 1 if tg is None else _world(tg)
        # JAX's capacity, over the global batch
        cap = max(int(t * n_tok / e * self.capacity_factor * k_top), 1)
        table = min(cap, t * k_top)        # the slots this rank can fill
        sown = _collector()
        want_aux = sown is not None or torch.is_grad_enabled()

        logits = F.linear(tokens.float(), self.router.weight.float(),
                          self.router.bias.float())
        probs = torch.softmax(logits, dim=-1)
        experts = torch.arange(e, device=x.device)

        aux = None
        remaining = probs.detach()
        used = torch.zeros(e, dtype=torch.int64, device=x.device)
        used_here = used
        rounds = []                          # (choice, slot, gate, keep)
        for k in range(k_top):
            choice = torch.argmax(remaining, dim=-1)               # (T,)
            gate = probs.gather(1, choice[:, None])[:, 0]
            onehot = (experts[:, None] == choice).to(torch.int32)  # (E, T)
            count = onehot.sum(1)                                  # (E,)
            if k == 0 and want_aux:
                aux = load_balance_loss(probs, onehot.t(), tg)
            # the capacity rank in token order: one scan over the experts'
            # rows laid end to end (a 1-D scan; a scan down the token axis
            # of a (T, E) mask runs E threads on the card), less the rows
            # before; offset by the slots that earlier rounds took
            running = onehot.view(-1).cumsum(0, dtype=torch.int32)
            rank = running.view(e, t).gather(0, choice[None])[0] \
                - (count.cumsum(0) - count)[choice] - 1
            before, total = _prefix_counts(count, tg)
            keep = rank + before[choice] + used[choice] < cap
            slot = (rank + used_here[choice]).clamp(max=table - 1)
            rounds.append((choice, slot, gate, keep))
            used, used_here = used + total, used_here + count
            remaining = remaining.scatter(1, choice[:, None], 0.0)
        if sown is not None:
            with torch.no_grad():
                self._sow_metrics(sown, rounds, t * n_tok, cap)

        # the (E, table) slot -> token table; dropped tokens write the
        # dummy row e, which nothing reads
        slot_token = torch.zeros((e + 1) * table, dtype=torch.int64,
                                 device=x.device)
        slot_filled = torch.zeros((e + 1) * table, dtype=tokens.dtype,
                                  device=x.device)
        arange_t = torch.arange(t, device=x.device)
        flats = []
        for choice, slot, _, keep in rounds:
            flat = choice * table + slot
            flats.append(flat)
            safe = torch.where(keep, flat, e * table + slot)
            slot_token.scatter_(0, safe, arange_t)
            slot_filled.scatter_(0, safe, torch.ones_like(tokens[:, 0]))

        group = self.expert_group
        if group is None:
            lo, local = 0, e
            src = tokens
        else:
            from .collectives import copy_to_model
            local = e // _world(group)
            lo = _rank(group) * local
            src = copy_to_model(tokens, group)
        sl = slice(lo * table, (lo + local) * table)
        expert_in = src.index_select(0, slot_token[sl]).view(
            local, table, d) * slot_filled[sl].view(local, table, 1)
        expert_out = self.experts(expert_in)
        if group is not None:
            from ._seq_adapter import seq_gather
            expert_out = seq_gather(expert_out, 0, group)
        flat_out = expert_out.reshape(e * table, d)

        # combine: each token's slot output weighted by its gate, the
        # gates normalised over the kept ones when top_k > 1
        if k_top > 1:
            gate_sum = sum(g * kp for _, _, g, kp in rounds)
        out = None
        for (_, _, gate, keep), flat in zip(rounds, flats):
            w = gate * keep
            if k_top > 1:
                w = w / torch.clamp(gate_sum, min=1e-9)
            term = flat_out.index_select(0, flat) * w[:, None].to(
                flat_out.dtype)
            out = term if out is None else out + term
        out = dropout(out, self.drop, not self.training, rng)
        if aux is not None:
            aux = self.aux_weight * aux
        return out.reshape(b, n, d), aux

    def _sow_metrics(self, sown, rounds, t: int, cap: int) -> None:
        """The routing's health over the global batch of ``t`` tokens
        (drop rate, capacity use, the most loaded expert over the mean
        load), as JAX sows it."""
        e = self.num_experts
        experts = torch.arange(e, device=rounds[0][0].device)
        counts = None                      # [kept, per expert kept ...]
        for choice, _, _, keep in rounds:
            kept = keep.float()
            load = ((choice[:, None] == experts).float()
                    * kept[:, None]).sum(0)
            c = torch.cat([kept.sum()[None], load])
            counts = c if counts is None else counts + c
        if self.token_group is not None:
            from .collectives import all_reduce
            all_reduce(counts, self.token_group)
        n_assigned, per_expert = counts[0], counts[1:]
        sown["moe_metrics"].append({
            "drop_rate": 1.0 - n_assigned / (t * self.top_k),
            "capacity_util": n_assigned / (e * cap),
            "max_expert_load": per_expert.max()
            / torch.clamp(per_expert.mean(), min=1.0)})


def _world(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _rank(group) -> int:
    import torch.distributed as dist
    return dist.get_rank(group)


def _prefix_counts(count: torch.Tensor, group
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the tokens of the token group's earlier ranks, of all its ranks)
    that chose each expert, from this rank's ``count`` (E,)."""
    if group is None:
        return torch.zeros_like(count), count
    from .collectives import all_gather_dim0
    n = _world(group)
    every = count.new_empty((n,) + tuple(count.shape))
    all_gather_dim0(every, count[None].contiguous(), group)
    return every[:_rank(group)].sum(0), every.sum(0)


def bind_expert_parallel(model: nn.Module,
                         layouts: Dict[str, NamedSharding],
                         mesh: Mesh) -> frozenset:
    """Every ``MoEMlp`` of ``model`` on ``mesh``: its ``token_group`` is
    the data x fsdp group when that has more than one rank (the routing
    then covers the global batch, as JAX's GSPMD routing does), and its
    ``expert_group`` the expert group when ``layouts`` split all its
    expert leaves over ``expert`` alone along dim 0 (``MOE_RULES``); it
    then runs on its slice of the experts. A layer whose expert leaves are
    split otherwise gets no expert group (the step all-gathers them before
    the forward). Returns the names of the parameters the bound layers use
    as slices. Collective the first time (the groups), so every rank calls
    it, before the state is cut to the layouts."""
    from .mesh import DATA_AXIS, FSDP_AXIS
    dp = (DATA_AXIS, FSDP_AXIS)
    n = mesh.shape[EXPERT_AXIS]
    moes = [(prefix, mod) for prefix, mod in model.named_modules()
            if isinstance(mod, MoEMlp)]
    tokens = mesh.group(dp) if moes and mesh.axis_size(dp) > 1 else None
    group = mesh.group(EXPERT_AXIS) if moes and n > 1 else None
    native: set = set()
    for prefix, mod in moes:
        mod.token_group = tokens
        want = (mod.ep_layout(n) if group is not None else None) or {}
        names = {f"{prefix}.{k}" if prefix else k: dim
                 for k, dim in want.items()}
        bound = bool(names) and all(
            layouts[nm].dims() == [(dim, (EXPERT_AXIS,))]
            for nm, dim in names.items())
        mod.expert_group = group if bound else None
        if bound:
            native.update(names)
    return frozenset(native)
