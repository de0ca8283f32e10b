"""Tensor (intra-layer) parallelism over a ``torch.distributed`` group:
the Megatron split of a model's projections, as explicit collectives.

Port of the JAX package's ``parallel/tensor_parallel.py`` for serving.
The JAX package states a placement per parameter path (``PartitionSpec``
rules) and lets GSPMD insert the collectives; PyTorch has no such
partitioner for the serving kernels (DTensor has no sharding rule for a
custom launch), so the port runs SPMD over a process group in PyTorch's
own idiom: every rank of a ``tp``-wide group holds its shard of each
weight (:func:`shard_params`), runs the same forward on it and issues the
collectives itself through :class:`TensorParallel` — one ``all_reduce``
after each row-parallel projection and one ``all_gather`` of the
vocab-split logits — each counted by kind (the counterpart of the JAX
``audit_hlo``: a stray collective shows as a count, where the JAX audit
reads it from the compiled program).

Rules are ``(pattern, dim, unit)``: the first pattern that matches a
leaf's name splits its dimension ``dim`` into ``tp`` contiguous blocks,
the rank taking block ``rank``; ``unit`` names a granule the block must
hold whole (``"head"``: a projection's head axis is flattened into its
output, so a split must fall between heads). A dimension whose granules
the group size does not divide stays replicated — the shape-aware drop of
the JAX ``spec_for_path``: GQA's K/V heads under a wider group keep every
head on every rank while the query heads shard. Unmatched leaves
(embeddings, norms, per-slot bookkeeping) replicate. The model's rules
are :data:`..models.transformer.TP_RULES` and ``INT8_TP_RULES``; the
slot state's are :data:`SLOT_STATE_RULES`.

Training (the JAX ``Trainer(..., strategy=TensorParallel(mesh, TP_RULES))``,
whose collectives GSPMD inserts) runs the same split with Megatron's two
autograd-aware collectives, issued by the model through the strategy:
:meth:`TensorParallel.copy_to` (``f``, at the entry of a column-parallel
region: identity forward, the input gradient's ``all_reduce`` backward) and
:meth:`TensorParallel.reduce_from` (``g``, after a row-parallel
projection: ``all_reduce`` forward, identity backward); the vocab-split
logits are gathered by :meth:`TensorParallel.gather_from` (backward: the
rank's slice), and the logits-free loss reduces its own lse and dh
(:func:`..ops.fused_loss.fused_cross_entropy_tp`). A strategy built on a
``{"data": d, "model": tp}`` mesh (:func:`..parallel.mesh.create_mesh`, the
model axis inner) is also the ``Trainer``'s data-parallel strategy over
the data axis: ``num_devices``, ``data_rank``, ``data_group``,
``shard_batch`` and, through :meth:`TensorParallel.shard_state`, the
data-axis gradient average and the model group's agreement on the skip
flag. ``rank`` and ``group`` stay the MODEL group's, which every sharded
layer reads.

The JAX strategy's other axes (``TensorParallel(mesh, rules,
seq_axis=)``): a mesh with a ``seq`` axis and ``seq_axis="seq"`` is
sequence parallelism — each rank holds its block of the sequence (the
loader's ``batch_spec``), and the gradients and the loss are averaged
over the data axis and then the seq axis (``seq_group``, counted
``"seq_all_reduce"``); a mesh with an ``expert`` axis wider than one is
expert parallelism (the JAX ``ep_rules()``: the experts always shard over
it) — :attr:`TensorParallel.expert` is the expert group's own
strategy, whose ``copy_to`` and ``reduce_from`` the MoE blocks issue
(counted in its ``collectives``). A mesh without a ``model`` axis is a
model group of one.

One card, two ranks: NCCL refuses a communicator whose ranks share a
device, so a TP world on a machine with fewer cards than ranks runs gloo,
which stages CUDA tensors through host memory. That proves the shard
arithmetic and the collective count on the card, not TP's speed.
:func:`spawn_tp` takes the backend as an argument and never picks one.
"""

from __future__ import annotations

import os
import re
import tempfile
from collections.abc import Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import (
    all_reduce_mean_,
    bucket_plan,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import DataParallel
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
)

# Sharded serving: the slot state's K/V (and their scales) split on the
# HEAD axis, matching the head-split q/k/v projections, so every cache
# write, splice, chunk and paged gather stays on its rank with no
# collective. Written against trailing dims — (..., heads, D) leaves and
# (..., heads) scales — so one rule covers the whole-slot cache (L, B,
# W + 1, KV, D), the page pools (L, N + 1, page, KV, D) and the batch-1
# side caches and segments. Everything else (positions, page tables,
# tokens, budgets, generators, history, adapter ids) replicates.
SLOT_STATE_RULES = [
    (r"(^|\.)(k|v)_scale$", -1, None),
    (r"(^|\.)(k|v)$", -2, None),
]
_KV_LEAF_RE = re.compile(r"(^|\.)(k|v)(_scale)?$")
# the serving forward's kinds, always counted; training adds its own on
# first use: "g" (a row-parallel output's forward sum), "f" (a column
# region's input-gradient sum), "lse_max" / "lse_sum" / "dh" (the
# vocab-split loss), "flag_min" (the skip flag's agreement) and
# "data_all_reduce" (the data-axis gradient average, one a bucket)
COLLECTIVE_KINDS = ("all_reduce", "all_gather")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def split_dim(name: str, shape: Sequence[int], rules, tp: int,
              units: Mapping[str, int] | None = None) -> int | None:
    """The dimension of a ``shape`` leaf called ``name`` that ``rules``
    split over a ``tp``-wide group, or None (replicated): the first
    matching rule's ``dim``, dropped when the group size does not divide
    its count of ``unit`` granules (``units`` maps a unit's name to its
    size; a rule without one splits single elements)."""
    for pattern, dim, unit in rules:
        if re.search(pattern, name):
            if tp <= 1 or not shape:
                return None
            d = dim % len(shape)
            g = (units or {}).get(unit, 1) if unit else 1
            if shape[d] % g or (shape[d] // g) % tp:
                return None
            return d
    return None


def shard_tensor(t: torch.Tensor, dim: int | None, rank: int, tp: int, *,
                 view: bool = False) -> torch.Tensor:
    """Block ``rank`` of ``tp`` contiguous blocks of ``t`` along ``dim``
    (``t`` itself when ``dim`` is None). A copy that owns its memory,
    contiguous, so the full tensor can be freed — unless ``view``, which
    keeps a view into ``t`` (a bank's factor tensors, whose in-place row
    writes the view must see)."""
    if dim is None:
        return t
    n = t.shape[dim] // tp
    part = t.narrow(dim, rank * n, n)
    return part if view else part.contiguous()


def shard_params(tree: Mapping[str, torch.Tensor], rank: int, tp: int, *, head_dim: int,
                 rules=None, views: bool = False) -> dict[str, torch.Tensor]:
    """The rank's shard of a state dict from the weight bridge
    (:func:`..models.convert.from_jax_params`): every leaf sliced per
    ``rules`` (default the transformer's ``TP_RULES`` + ``INT8_TP_RULES``
    + its LoRA rules), ``head_dim`` the size of a ``"head"`` unit. Column
    layers (q/k/v, gate/up, lm_head) split their output and, int8, their
    per-column scales; row layers (o, down) their input, with scales
    replicated; embedding and norms replicate; ``*_lora`` factors shard
    like their base projection (``lora_b``'s output for a column layer,
    ``lora_a``'s input for a row layer). int8 ``qt`` (N, K) row shards are
    copied contiguous (the sm90 kernel's route needs 16-byte bases and a
    dense K). ``views``: slices stay views of the caller's tensors."""
    if rules is None:
        from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
            SERVING_TP_RULES,
        )

        rules = SERVING_TP_RULES
    units = {"head": head_dim}
    return {name: shard_tensor(t, split_dim(name, tuple(t.shape), rules, tp, units),
                               rank, tp, view=views)
            for name, t in tree.items()}


def _group_of(group_or_mesh):
    """A process group from a group, a mesh (its ``model`` axis's group;
    None without a model axis: a model group of one), or None (no group: a
    world of one)."""
    names = getattr(group_or_mesh, "mesh_dim_names", None)
    if names is not None:
        return group_or_mesh.get_group(MODEL_AXIS) if MODEL_AXIS in names else None
    return group_or_mesh


def _axis_group(mesh, axis: str | None):
    """``(size, rank, group)`` of ``axis`` in ``mesh``: ``(1, 0, None)``
    where the mesh lacks the axis or it is one wide."""
    if mesh is None or axis is None or axis not in mesh.mesh_dim_names:
        return 1, 0, None
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if size == 1:
        return 1, 0, None
    return size, mesh.get_local_rank(axis), mesh.get_group(axis)


class _CopyTo(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, the gradient summed over
    the model group backward (each rank's column shard saw the whole
    input, and its gradient holds only that shard's part)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.reduce_(grad.clone(), "sum", "f"), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's ``g``: the row-parallel partials summed over the model
    group forward (into a new tensor: the summed-in partial may be saved
    for the backward), the identity backward (every rank's output
    gradient is the whole one)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.reduce_(x.clone(), "sum", "g")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    """The vocab-split logits gathered along ``dim`` in rank order; the
    backward takes the rank's slice of the (identical) whole gradient."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n).contiguous(), None, None


class TensorParallel:
    """The tensor-parallel strategy of one rank: the ``model`` group, its
    size ``tp_size`` and this process's ``rank`` in it, and the
    collectives the sharded forward and backward issue, counted by kind in
    :attr:`collectives`.

    ``group``: a ``torch.distributed`` process group, a mesh
    (:func:`..parallel.mesh.create_mesh`: its ``model`` axis the model
    group, none a group of one; a ``data`` axis the data-parallel side of
    training over it; ``seq`` with ``seq_axis`` and ``expert`` as the
    module docstring says), or None — a strategy of one rank (``tp_size``
    1), which shards nothing: an engine or model given it is the
    replicated one. ``rules``: the JAX call's rules, taken for the call's
    shape and not read — the port's model knows its Megatron split and
    its expert split. Every rank of the group must make the same calls in
    the same order (SPMD)."""

    def __init__(self, group=None, rules=None, *, seq_axis: str | None = None):
        self.mesh = group if hasattr(group, "mesh_dim_names") else None
        self.group = _group_of(group)
        if self.group is None:
            self.tp_size, self.rank = 1, 0
        else:
            self.tp_size = dist.get_world_size(self.group)
            self.rank = dist.get_rank(self.group)
        if seq_axis is not None and self.mesh is None:
            raise ValueError("seq_axis names an axis of a mesh: pass the mesh")
        # the data axis beside the model axis (none without a mesh); the
        # seq axis (when named and present) averages with it
        self._data = DataParallel(self.mesh) if self.mesh is not None else None
        self.seq_axis = seq_axis
        self.seq_size, self.seq_rank, self.seq_group = _axis_group(self.mesh, seq_axis)
        # the expert axis: the MoE experts' group, a strategy of its own
        # (its copy_to / reduce_from)
        size, _, ep_group = _axis_group(self.mesh, EXPERT_AXIS)
        self.expert = TensorParallel(ep_group) if size > 1 else None
        self.collectives = dict.fromkeys(COLLECTIVE_KINDS, 0)

    @property
    def ep_size(self) -> int:
        """The expert-parallel width (1: every rank holds every expert)."""
        return 1 if self.expert is None else self.expert.tp_size

    @property
    def ep_rank(self) -> int:
        return 0 if self.expert is None else self.expert.rank

    @property
    def mesh_shape(self) -> dict[str, int]:
        data = {} if self.num_devices == 1 else {"data": self.num_devices}
        seq = {} if self.seq_size == 1 else {SEQ_AXIS: self.seq_size}
        ep = {} if self.ep_size == 1 else {EXPERT_AXIS: self.ep_size}
        return {**data, **seq, **ep, MODEL_AXIS: self.tp_size}

    @property
    def num_devices(self) -> int:
        """The data-axis width (the strategies' interface contract: how
        many ways the batch's dim 0 is split), not the device count."""
        return 1 if self._data is None else self._data.num_devices

    @property
    def data_rank(self) -> int:
        return 0 if self._data is None else self._data.rank

    @property
    def data_group(self):
        """The data-axis group (None for a data axis of one): the ranks of
        this rank's model coordinate."""
        return None if self._data is None else self._data.group

    @property
    def backend(self) -> str | None:
        return None if self.group is None else str(dist.get_backend(self.group))

    def __repr__(self) -> str:
        return f"TensorParallel(tp={self.tp_size}, rank={self.rank}, backend={self.backend})"

    def reset_collectives(self) -> None:
        self.collectives = dict.fromkeys(COLLECTIVE_KINDS, 0)
        if self.expert is not None:
            self.expert.reset_collectives()

    def reduce_(self, x: torch.Tensor, op: str = "sum", kind: str = "all_reduce"
                ) -> torch.Tensor:
        """``x`` reduced over the group in place by ``op`` ("sum", "max" or
        "min"), counted under ``kind``; returns ``x``. A strategy of one
        rank returns ``x`` untouched and counts nothing."""
        if self.tp_size == 1:
            return x
        self.collectives[kind] = self.collectives.get(kind, 0) + 1
        dist.all_reduce(x, op=_OPS[op], group=self.group)
        return x

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group in place (the serving forward's
        row-parallel partials, with no autograd); returns ``x``. Counted."""
        return self.reduce_(x)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``f`` before a column-parallel region (training):
        ``x`` forward; its gradient summed over the group backward
        (counted ``"f"``)."""
        return x if self.tp_size == 1 else _CopyTo.apply(x, self)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``g`` after a row-parallel projection (training): the
        partials' sum over the group in a new tensor (counted ``"g"``),
        the gradient passed through."""
        return x if self.tp_size == 1 else _ReduceFrom.apply(x, self)

    def gather_from(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """:meth:`all_gather` with a gradient: the rank's slice of it."""
        return x if self.tp_size == 1 else _GatherFrom.apply(x, self, dim % x.ndim)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order (the
        vocab-split logits' gather): the same bytes on every rank. Counted."""
        if self.tp_size == 1:
            return x
        self.collectives["all_gather"] += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.tp_size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def shard_state(self, state, rules=SLOT_STATE_RULES, *, head_dim: int = 1):
        """Place a state on this rank, as the JAX ``shard_state`` places one
        per the rules. A mapping of tensors (serving's slot state): this
        rank's shard of every leaf per ``rules`` (default the slot-state
        rules), :func:`shard_params` at this rank. A train state (the
        ``Trainer``'s, whose model already holds this rank's shard): over
        the data axis what :meth:`..DataParallel.shard_state` does (rank
        0's shards broadcast to the data group, ``grad_sync`` the data-axis
        average, counted ``"data_all_reduce"``, then the seq-axis average,
        ``"seq_all_reduce"``), and ``flag_sync`` the MIN of the skip flag
        over the model group and the expert group (counted ``"flag_min"``),
        so ranks that each see only their shards' gradients skip
        together."""
        if isinstance(state, Mapping):
            return shard_params(state, self.rank, self.tp_size, head_dim=head_dim,
                                rules=rules)
        if self._data is not None:
            state = self._data.shard_state(state)
        averaged = self.data_group is not None or self.seq_group is not None
        state.grad_sync = self._data_mean_ if averaged else None
        sharded = [g for g in (self, self.expert) if g is not None and g.tp_size > 1]
        state.flag_sync = (lambda ok: self._flag_min(ok, sharded)) if sharded else None
        return state

    @staticmethod
    def _flag_min(ok: torch.Tensor, groups: list) -> torch.Tensor:
        """The skip flag's MIN over the model group and the expert group
        (ranks that hold different shards see different gradients)."""
        for g in groups:
            ok = g.reduce_(ok, "min", "flag_min")
        return ok

    def _data_mean_(self, tensors: list[torch.Tensor]) -> None:
        """The gradients (and the loss) averaged over the data axis, then
        over the seq axis (each seq rank holds its block of the sequence:
        the mean over data x seq, one bucketed ``all_reduce`` a group)."""
        n = len(bucket_plan(tensors))
        if self.data_group is not None:
            self.collectives["data_all_reduce"] = self.collectives.get("data_all_reduce", 0) + n
            self._data.all_reduce_mean_(tensors)
        if self.seq_group is not None:
            self.collectives["seq_all_reduce"] = self.collectives.get("seq_all_reduce", 0) + n
            all_reduce_mean_(tensors, self.seq_group, self.seq_size)

    def shard_batch(self, batch):
        """This rank's rows of a global batch: its data coordinate's block
        of dim 0 (every model rank of a coordinate the same rows). A
        strategy without a mesh has a data axis of one: the batch as
        given."""
        return batch if self._data is None else self._data.shard_batch(batch)

    def shard_shapes(self, shapes: Mapping[str, Sequence[int]], rules=SLOT_STATE_RULES, *,
                     units: Mapping[str, int] | None = None) -> dict[str, tuple]:
        """The shard shape of each global ``shapes`` entry per ``rules``
        (default the slot-state rules): what this rank's leaves must be."""
        out = {}
        for name, shape in shapes.items():
            shape = tuple(shape)
            d = split_dim(name, shape, rules, self.tp_size, units)
            out[name] = shape if d is None else (
                shape[:d] + (shape[d] // self.tp_size,) + shape[d + 1:])
        return out

    def audit(self, params: Mapping[str, torch.Tensor], slot_state=None, *, rules=None,
              head_dim: int = 1) -> list[str]:
        """``name: global shape -> split dim`` lines for every weight of
        ``params`` (global shapes) per ``rules`` (default the transformer's),
        and with ``slot_state`` (name -> global shape) for the slot state
        under :data:`SLOT_STATE_RULES`, where a K/V leaf that stays
        replicated under ``tp_size`` > 1 gets a WARNING: each rank then
        holds the whole cache (usual cause: a KV head count the group size
        does not divide)."""
        if rules is None:
            from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
                SERVING_TP_RULES,
            )

            rules = SERVING_TP_RULES
        units = {"head": head_dim}
        lines = []
        for name, t in params.items():
            shape = tuple(t.shape)
            lines.append(f"{name}: {shape} -> {split_dim(name, shape, rules, self.tp_size, units)}")
        for name, shape in (slot_state or {}).items():
            shape = tuple(shape)
            d = split_dim(name, shape, SLOT_STATE_RULES, self.tp_size)
            line = f"{name}: {shape} -> {d}"
            if self.tp_size > 1 and _KV_LEAF_RE.search(name) and d is None:
                line += (f" WARNING: KV leaf replicated under tp={self.tp_size} — each rank "
                         "holds the whole cache; check that the group size divides the "
                         "KV head count")
            lines.append(line)
        return lines


def _tp_rank(rank: int, fn: Callable, tp: int, coordinator: str, backend: str, device: str,
             outdir: str, args: tuple) -> None:
    """One rank of :func:`spawn_tp`: form the group, run ``fn(strategy,
    *args)``, save its result to ``outdir/rank{rank}.pt``, tear down."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import distributed

    distributed.init(coordinator, tp, rank, device=device, backend=backend)
    try:
        out = fn(TensorParallel(dist.group.WORLD), *args)
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def spawn_tp(fn: Callable, tp: int, args: Sequence = (), *, backend: str, device: str,
             join_timeout_s: float = 600.0) -> list:
    """Run ``fn(strategy, *args)`` in a world of ``tp`` spawned processes
    (a :class:`TensorParallel` over the whole world each) and return the
    ranks' results in rank order. ``fn`` is a module-level callable (the
    spawn start method pickles it by name) and its result something
    ``torch.save`` takes. ``backend`` ("gloo" or "nccl") and ``device``
    ("cpu" or "cuda") are the caller's explicit choice. A rank that fails
    fails the call (:func:`..launch.spawn` raises)."""
    from pytorch_distributed_training_tutorials_tpu_torch.launch._spawn import (
        coordinator_for_spawn,
        spawn,
    )

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    with tempfile.TemporaryDirectory(prefix="tp_world_") as outdir:
        spawn(_tp_rank, tp, args=(fn, tp, coordinator_for_spawn(), backend, device, outdir,
                                  tuple(args)),
              join_timeout_s=join_timeout_s)
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(tp)]
