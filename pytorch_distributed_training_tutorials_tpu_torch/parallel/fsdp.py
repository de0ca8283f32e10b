"""FSDP / ZeRO: parameter and optimizer-state sharding over the data axis.

Port of the JAX package's ``parallel/fsdp.py``. The JAX package annotates
every large parameter (and, by the same shape rule, its optimizer
moments) as sharded over ``data`` and lets GSPMD compile the schedule: an
all-gather of each weight before its use, a reduce-scatter of its
gradient. The port issues both itself, explicitly and counted, as
:class:`..parallel.tensor_parallel.TensorParallel` issues its
collectives:

- each sharded leaf's ``Parameter`` becomes this rank's contiguous shard;
  the module's weight is its full gather, through
  ``torch.nn.utils.parametrize``, so the models stay unchanged — the JAX
  design point "no wrapper module, no hooks";
- the gather is an ``autograd.Function``: ``all_gather`` forward, the
  gradient's ``reduce_scatter`` over the data group, averaged, backward;
- replicated leaves (fewer than ``min_size`` elements, or no dimension
  the group divides) average their gradients as ``DataParallel`` does;
- the optimizer — the fused AdamW kernel included — sees the shards only,
  so ZeRO-1's sharded moments fall out, as in the JAX package.

It is not built on FSDP2's ``fully_shard``: the port's train step takes
gradients with ``torch.autograd.grad``, which fires no ``.grad``
accumulation, so FSDP2's post-backward reduce-scatter would never run.

**Layout.** The JAX rule picks its dimension on flax's shapes: a Dense
kernel (in, out), a Conv kernel HWIO, q/k/v (d_model, heads, head_dim),
o_proj (heads, head_dim, d_model). The port stores ``Linear`` as (out,
in), ``Conv`` as OIHW and the transformer's projections flattened to
(K, N). :func:`logical_layout` gives a leaf's flax shape and which flax
dimensions each port dimension holds; the rule runs on the flax shape
(a tie, such as a (64, 64) kernel, then picks the same logical dimension
as the JAX package) and the choice maps back to the port's dimension.
The numbers would be the same either way; the placement parity test is
what would see the difference.

**Routes.** NCCL, and gloo on CPU tensors, take ``all_gather_into_tensor``
and ``reduce_scatter_tensor``. Gloo on CUDA tensors (ranks that share
one card: NCCL refuses a communicator whose ranks share a device) takes
``all_gather`` and ``all_reduce``, staging through host memory, so there
the gradient is all-reduced and the rank keeps its slice. The route is
chosen from the backend and the device when the strategy is built
(:attr:`FSDP.route`) and its collectives counted under their own names.

BatchNorm's running statistics are buffers, not parameters: they stay
replicated (the JAX rule would shard one of 1,024 channels or more).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import (
    all_reduce_mean_,
    bucket_plan,
    stages_through_host,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import DataParallel
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    mesh_device,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    split_dim,
)

# the two routes (module docstring): the ops each issues, by direction
TENSOR_ROUTE = ("all_gather_into_tensor", "reduce_scatter_tensor")
STAGED_ROUTE = ("all_gather", "all_reduce_shard")


def shard_dim_for(shape: tuple[int, ...], world: int, min_size: int,
                  exclude: tuple[int, ...] = ()) -> int | None:
    """The dimension to shard over ``world`` devices, or None.

    The largest dimension divisible by ``world`` wins (a tie: the
    earliest), for the largest saving; leaves of fewer than ``min_size``
    elements, and scalars, stay replicated (a bias of 10 floats buys
    nothing and costs a gather). ``exclude`` lists dimensions another axis
    claimed (HybridFSDP's TP pass)."""
    if not shape:
        return None
    total = 1
    for d in shape:
        total *= d
    if total < min_size:
        return None
    best: int | None = None
    for i, d in enumerate(shape):
        if i in exclude:
            continue
        if d % world == 0 and (best is None or d > shape[best]):
            best = i
    return best


def logical_layout(module: nn.Module, leaf: str, shape: Sequence[int]
                   ) -> tuple[tuple[int, ...], list[list[int]]]:
    """A port leaf's flax layout: its shape in flax's order, and for each
    port dimension the flax dimensions it holds, outermost first. ``Linear``
    weights (out, in) are flax (in, out); ``Conv`` OIHW is HWIO; the
    transformer's ``Dense`` (K, N) is its input axes then its output axes
    (q/k/v: (d_model, heads, head_dim); o_proj: (heads, head_dim,
    d_model)); every other leaf has flax's shape."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.mlp import Linear
    from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import Conv
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import Dense

    shape = tuple(shape)
    if leaf == "weight" and isinstance(module, Linear):
        return (shape[1], shape[0]), [[1], [0]]
    if leaf == "weight" and isinstance(module, Conv):
        o, i, h, w = shape
        return (h, w, i, o), [[3], [2], [0], [1]]
    if leaf == "weight" and isinstance(module, Dense):
        ins, feats = tuple(module.in_features), tuple(module.features)
        k = len(ins)
        return (*ins, *feats), [list(range(k)), list(range(k, k + len(feats)))]
    return shape, [[d] for d in range(len(shape))]


def _port_dim(name: str, groups: list[list[int]], flax_dim: int | None) -> int | None:
    """The port dimension whose contiguous blocks are ``flax_dim``'s."""
    if flax_dim is None:
        return None
    for p, held in enumerate(groups):
        if flax_dim in held:
            if held[0] != flax_dim:
                raise NotImplementedError(
                    f"{name}: flax dimension {flax_dim} is inside port dimension {p} "
                    f"(flax {held}); its blocks are not contiguous in the port's layout")
            return p
    raise ValueError(f"{name}: no port dimension holds flax dimension {flax_dim}")


def param_names(model: nn.Module) -> list[str]:
    """The model's parameter names as before sharding: a parametrized
    leaf's ``prefix.parametrizations.leaf.original`` is ``prefix.leaf``."""
    return [name.replace(".parametrizations.", ".").removesuffix(".original")
            if ".parametrizations." in name else name for name, _ in model.named_parameters()]


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One parameter's placement: its flax shape, its spec in flax's
    order (an axis name or None a dimension, the JAX ``PartitionSpec``),
    and the port dimension sharded over the data axis (None: replicated
    over it)."""

    flax_shape: tuple[int, ...]
    spec: tuple
    dim: int | None


class _Gather(torch.autograd.Function):
    """A weight's full gather from the rank shards along ``dim``; the
    backward reduce-scatters the gradient over the data group and
    averages it."""

    @staticmethod
    def forward(ctx, shard, fsdp, dim):
        ctx.fsdp, ctx.dim = fsdp, dim
        return fsdp.gather(shard, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fsdp.reduce_scatter_mean(grad, ctx.dim), None, None


class _Gathered(nn.Module):
    """The parametrization: the stored tensor is the rank's shard
    (``right_inverse``), the module sees its gather (``forward``)."""

    def __init__(self, fsdp: "FSDP", dim: int):
        super().__init__()
        self.fsdp, self.dim = fsdp, dim

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(shard, self.fsdp, self.dim)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return self.fsdp.shard_of(full, self.dim)


class FSDP:
    """Shape-driven ZeRO-3 sharding over the data axis, a drop-in for
    ``DataParallel`` in the Trainer::

        mesh = create_mesh()                     # {'data': N}
        trainer = Trainer(model, loader, opt, strategy=FSDP(mesh))

    Every parameter of at least ``min_size`` elements with a dimension the
    axis divides is sharded on it (:func:`shard_dim_for` on its flax
    layout); the rest replicate. The batch splits over the same axis. A
    data axis of one shards nothing and issues no collective (the JAX mesh
    of one device holds every leaf whole): the step is ``DataParallel``'s.
    :attr:`collectives` counts by kind: the route's two ops
    (:attr:`route`), ``data_all_reduce`` (the replicated leaves' gradient
    buckets with the loss) and ``flag_min`` (the skip flag, which each rank
    computes from its shards, agreed over the group)."""

    def __init__(self, mesh=None, axis: str = DATA_AXIS, *, min_size: int = 1024):
        self.mesh = mesh if mesh is not None else create_mesh()
        self.axis = axis
        self.min_size = min_size
        self._data = DataParallel(self.mesh, axis)
        self.plan: dict[str, LeafPlan] = {}
        self.collectives: dict[str, int] = {}
        self._replicated: list[int] = []
        if self.group is None:
            self.route = None
        elif stages_through_host(self.group, mesh_device(self.mesh)):
            self.route = STAGED_ROUTE
        else:
            self.route = TENSOR_ROUTE

    @property
    def num_devices(self) -> int:
        """The data-axis width (the strategies' interface contract)."""
        return self._data.num_devices

    @property
    def rank(self) -> int:
        return self._data.rank

    @property
    def group(self):
        """The data group (None for a data axis of one)."""
        return self._data.group

    @property
    def sharded(self) -> bool:
        """True when the state is split across ranks (a checkpoint gathers
        it)."""
        return self.num_devices > 1

    def __repr__(self) -> str:
        route = "none" if self.route is None else " + ".join(self.route)
        return f"{type(self).__name__}(data={self.num_devices}, route={route})"

    def reset_collectives(self) -> None:
        self.collectives = {}

    def _count(self, kind: str, n: int = 1) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0) + n

    # -- placement --------------------------------------------------------
    def spec_for(self, shape: Sequence[int]) -> tuple:
        """The spec of a leaf of flax shape ``shape``: the axis name on the
        dimension :func:`shard_dim_for` picks, None elsewhere; ``()`` when
        it stays replicated (the JAX ``PartitionSpec()``)."""
        dim = shard_dim_for(tuple(shape), self.num_devices, self.min_size)
        if dim is None:
            return ()
        return tuple(self.axis if i == dim else None for i in range(len(shape)))

    def leaf_plan(self, model: nn.Module, name: str) -> LeafPlan:
        """The placement of ``model``'s parameter ``name`` (its name before
        sharding; a leaf this strategy sharded answers from :attr:`plan`:
        reading its shape would gather it)."""
        prefix, _, leaf = name.rpartition(".")
        module = model.get_submodule(prefix)
        if parametrize.is_parametrized(module, leaf):
            return self.plan[name]
        flax_shape, groups = logical_layout(module, leaf, getattr(module, leaf).shape)
        spec = self.spec_for(flax_shape)
        flax_dim = spec.index(self.axis) if self.axis in spec else None
        return LeafPlan(flax_shape, spec, _port_dim(name, groups, flax_dim))

    def variable_shardings(self, model: nn.Module) -> dict:
        """Every parameter's placement over the data axis by state-dict
        name (``Shard(dim)`` or ``Replicate()``); buffers replicated."""
        from torch.distributed.tensor import Replicate, Shard

        out = {name: (Replicate(),) for name, _ in model.named_buffers()}
        for name in param_names(model):
            dim = self.leaf_plan(model, name).dim
            out[name] = (Replicate(),) if dim is None else (Shard(dim),)
        return out

    def audit(self, model: nn.Module) -> list[str]:
        """``name: flax shape -> spec`` lines (the 03 notebook's placement
        audit), the spec in flax's dimension order."""
        return [f"{name}: {p.flax_shape} -> {p.spec}"
                for name, p in ((n, self.leaf_plan(model, n)) for n in param_names(model))]

    # -- the state ----------------------------------------------------------
    def _replicate(self, state):
        """Over the data axis what ``DataParallel.shard_state`` does: rank
        0's parameters and buffers broadcast, BatchNorm synced."""
        return self._data.shard_state(state)

    def shard_state(self, state):
        """Make a train state sharded: the data axis as ``DataParallel``
        makes it, then each planned leaf cut to this rank's shard behind
        its gather, the optimizer state rebuilt over the shards (ZeRO-1),
        ``grad_sync`` the replicated leaves' average and ``flag_sync`` the
        skip flag's MIN over the data group (after any earlier
        ``flag_sync``)."""
        state = self._replicate(state)
        model = state.model
        self.plan = {name: self.leaf_plan(model, name) for name in param_names(model)}
        if self.group is None:
            return state
        for name, p in self.plan.items():
            if p.dim is not None:
                prefix, _, leaf = name.rpartition(".")
                parametrize.register_parametrization(model.get_submodule(prefix), leaf,
                                                     _Gathered(self, p.dim), unsafe=True)
        shards = {id(m.parametrizations[leaf].original)
                  for m in model.modules() if parametrize.is_parametrized(m)
                  for leaf in m.parametrizations}
        state.opt_state = state.tx.init(state.params)
        self._replicated = [i for i, p in enumerate(state.params) if id(p) not in shards]
        state.grad_sync = self._sync_replicated
        before = state.flag_sync  # HybridFSDP: the model group's MIN first
        state.flag_sync = (self._flag_min if before is None
                           else lambda ok: self._flag_min(before(ok)))
        return state

    def shard_batch(self, batch):
        """This rank's rows of a global batch (``DataParallel``'s)."""
        return self._data.shard_batch(batch)

    # -- collectives --------------------------------------------------------
    def gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's shard concatenated along ``dim`` in rank order."""
        self._count(self.route[0])
        return self._all_gather(shard, dim)

    def unshard(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """A checkpoint's whole leaf from every rank's ``shard`` (a
        parameter's or one of its optimizer moments'), outside autograd;
        counted as ``checkpoint_gather``, apart from the step's gathers."""
        self._count("checkpoint_gather")
        with torch.no_grad():
            return self._all_gather(shard.detach(), dim)

    def shard_of(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of a whole leaf along ``dim`` (what a restore
        keeps of a checkpoint's leaf)."""
        n = full.shape[dim] // self.num_devices
        return full.narrow(dim, self.rank * n, n).contiguous()

    def _all_gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        w = self.num_devices
        x = shard.movedim(dim, 0).contiguous()
        if self.route is TENSOR_ROUTE:
            out = x.new_empty((w * x.shape[0], *x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:
            parts = [torch.empty_like(x) for _ in range(w)]
            dist.all_gather(parts, x, group=self.group)
            out = torch.cat(parts)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    def reduce_scatter_mean(self, grad: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of ``grad`` summed over the data
        group, divided by its width."""
        w = self.num_devices
        g = grad.movedim(dim, 0).contiguous()
        n = g.shape[0] // w
        self._count(self.route[1])
        if self.route is TENSOR_ROUTE:
            out = g.new_empty((n, *g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, group=self.group)
        else:
            if g is grad:
                g = g.clone()
            dist.all_reduce(g, group=self.group)
            out = g.narrow(0, self.rank * n, n)
        out = out.div_(w) if out.is_contiguous() else out.contiguous().div_(w)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    def _sync_replicated(self, tensors: list[torch.Tensor]) -> None:
        """``grad_sync``: ``tensors`` is the step's gradients in parameter
        order and the loss; the sharded leaves' gradients were averaged by
        their reduce-scatter, the rest are averaged here, in buckets."""
        rep = [tensors[i] for i in self._replicated] + [tensors[-1]]
        self._count("data_all_reduce", len(bucket_plan(rep)))
        all_reduce_mean_(rep, self.group, self.num_devices)

    def _flag_min(self, ok: torch.Tensor) -> torch.Tensor:
        self._count("flag_min")
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=self.group)
        return ok


class HybridFSDP(FSDP):
    """2D sharding: tensor-parallel rules over ``model``, FSDP over
    ``data`` — the llama-style layout::

        mesh = create_mesh({"data": D, "model": M})
        trainer = Trainer(TransformerLM(cfg), loader, opt,
                          strategy=HybridFSDP(mesh, TP_RULES))

    ``rules`` are the port's (:data:`..models.transformer.TP_RULES`,
    through :func:`..parallel.tensor_parallel.split_dim`): the Trainer
    builds the model as this rank's tensor-parallel shard on :attr:`tp`
    (Megatron's collectives over the model group, counted there), and of
    each weight FSDP then shards, over ``data``, the largest dimension the
    rules left free (on the weight's whole flax shape, as the JAX rule
    does). The skip flag is agreed over the model group, then the data
    group."""

    def __init__(self, mesh, rules, *, axis: str = DATA_AXIS, model_axis: str = MODEL_AXIS,
                 min_size: int = 1024):
        if model_axis != MODEL_AXIS:
            raise ValueError(f"the port's tensor parallelism runs over {MODEL_AXIS!r}")
        super().__init__(mesh, axis, min_size=min_size)
        self.rules = list(rules)
        self.model_axis = model_axis
        self.tp = TensorParallel(mesh)
        self._whole = None

    @property
    def sharded(self) -> bool:
        return super().sharded or self.tp.tp_size > 1

    def spec_for(self, shape):  # shape-only: ambiguous for 2D layouts
        raise NotImplementedError(
            "HybridFSDP placements depend on the parameter's name, not its shape alone: "
            "use leaf_plan or audit")

    def _whole_model(self, model: nn.Module) -> nn.Module:
        """The unsharded model's structure (on the meta device): the whole
        shapes the rules and the flax layout read."""
        from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
            TransformerLM,
        )

        if not isinstance(model, TransformerLM):
            raise TypeError("HybridFSDP shards a TransformerLM (the port's tensor "
                            f"parallelism), got {type(model).__name__}")
        cfg = dataclasses.replace(model.cfg, int8_mesh=None)
        if self._whole is None or self._whole.cfg != cfg:
            self._whole = TransformerLM(cfg)
        return self._whole

    def leaf_plan(self, model: nn.Module, name: str) -> LeafPlan:
        whole = self._whole_model(model)
        prefix, _, leaf = name.rpartition(".")
        module = whole.get_submodule(prefix)
        shape = tuple(getattr(module, leaf).shape)
        flax_shape, groups = logical_layout(module, leaf, shape)
        tp_dim = split_dim(name, shape, self.rules, self.tp.tp_size,
                           {"head": whole.cfg.head_dim})
        claimed = () if tp_dim is None else (groups[tp_dim][0],)
        flax_dim = shard_dim_for(flax_shape, self.num_devices, self.min_size, exclude=claimed)
        spec = tuple(self.model_axis if i in claimed else self.axis if i == flax_dim else None
                     for i in range(len(flax_shape)))
        return LeafPlan(flax_shape, spec, _port_dim(name, groups, flax_dim))

    def variable_shardings(self, model: nn.Module) -> dict:
        """Placements over (data, model) by name: the data shard's and the
        tensor-parallel split's port dimensions."""
        from torch.distributed.tensor import Replicate, Shard

        whole = self._whole_model(model)
        out = {name: (Replicate(), Replicate()) for name, _ in model.named_buffers()}
        for name, t in whole.named_parameters():
            p = self.leaf_plan(model, name)
            tp_dim = split_dim(name, tuple(t.shape), self.rules, self.tp.tp_size,
                               {"head": whole.cfg.head_dim})
            out[name] = tuple(Replicate() if d is None else Shard(d) for d in (p.dim, tp_dim))
        return out

    def _replicate(self, state):
        """The tensor-parallel strategy's ``shard_state``: over the data
        axis rank 0's shards broadcast and BatchNorm synced, and the skip
        flag's MIN over the model group."""
        return self.tp.shard_state(state)
