"""Device meshes, placement rules and the placements of a training state
(counterpart of ``gddim_tpu/parallel/mesh.py``).

The JAX package says everything through shardings and lets XLA insert the
collectives. The port writes them out, in PyTorch's idiom, keeping the JAX
names:

- the meshes are ``DeviceMesh``es over the process group's ranks, one card
  a rank, with the JAX axis names ``("data",)``, ``("data", "model")`` and
  ``("data", "fsdp", "model")``;
- data parallelism averages the gradients over the batch's ranks in one
  flat all-reduce (``Placement.reduce_gradients``), as DDP does;
- FSDP is FSDP2 (``fully_shard``) on each residual and attention block and
  on the root, the JAX rule choosing each leaf's dimension
  (``shard_placement_fn``). FSDP2 shards every leaf: where the rule leaves
  a small leaf replicated, FSDP2 shards it on dim 0, a difference of layout
  only (gathered on use, the gradient reduce-scattered, the values the
  same);
- channel TP (``tp_shard_params``) keeps each rank's slice of the output
  channels of every weight the rule shards; ``models/layers.py`` computes
  the plain path's slice and gathers it (``ChannelShard.gather``), and every
  other reader of the weight, a whole-block or layer-wise kernel, gets the
  whole weight gathered over the model group, as a Pallas call gets its
  operands whole from XLA (the JAX package wraps no ``pallas_call`` in
  ``shard_map`` or ``custom_partitioning``, so the SPMD partitioner
  gathers a custom call's sharded operands before it).

The batch is split over every axis but ``model``: the ranks of one model
group see the same samples. The placement rules are plain functions of a
shape (``fsdp_spec``, ``tp_spec``) returning the JAX ``PartitionSpec`` as a
tuple, so the tests hold them against the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gddim_torch.parallel.draws import BatchRows
from gddim_torch.parallel.multihost import process_count
from gddim_torch.train.state import is_dtensor, local_tensor


def _device_type(device_type: str | None) -> str:
    if device_type:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" or torch.cuda.is_available() else "cpu"


def make_mesh(n_data: int | None = None, device_type: str | None = None) -> DeviceMesh:
    """1-D data-parallel mesh over all (or ``n_data``) ranks."""
    n = process_count() if n_data is None or n_data <= 0 else n_data
    return init_device_mesh(_device_type(device_type), (n,), mesh_dim_names=("data",))


def make_mesh_2d(n_data: int, n_model: int, device_type: str | None = None) -> DeviceMesh:
    """2-D (data, model) mesh: data parallel x FSDP or channel TP."""
    return init_device_mesh(_device_type(device_type), (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def make_mesh_3d(n_data: int, n_fsdp: int, n_model: int,
                 device_type: str | None = None) -> DeviceMesh:
    """3-D (data, fsdp, model) mesh: batch DP x ZeRO-3 x channel TP."""
    return init_device_mesh(_device_type(device_type), (n_data, n_fsdp, n_model),
                            mesh_dim_names=("data", "fsdp", "model"))


# ---------------------------------------------------------------------------
# placement rules (gddim_tpu/parallel/mesh.py:101-159)
# ---------------------------------------------------------------------------


def fsdp_spec(shape, n: int, min_size: int = 2**16, axis: str = "data") -> tuple:
    """A leaf of at least ``min_size`` values shards along its largest
    dimension over ``axis`` if that dimension divides by ``n``; else it is
    replicated (all None)."""
    spec = [None] * len(shape)
    if int(np.prod(shape)) >= min_size and len(shape):
        dim = int(np.argmax(shape))
        if shape[dim] % n == 0:
            spec[dim] = axis
    return tuple(spec)


def tp_spec(shape, n: int, axis: str = "model", fsdp_axis: str | None = None, n_fsdp: int = 1,
            min_size: int = 2**12) -> tuple:
    """A leaf of at least 2 dimensions and ``min_size`` values shards its last
    (output-channel) dimension over ``axis`` where it divides by ``n``; with
    ``fsdp_axis`` its largest other dimension that divides by ``n_fsdp``
    (and is above 1) over that axis. 1-D and small leaves are replicated."""
    spec = [None] * len(shape)
    if len(shape) < 2 or int(np.prod(shape)) < min_size:
        return tuple(spec)
    if shape[-1] % n == 0:
        spec[-1] = axis
    if fsdp_axis:
        rest = [d for d in range(len(shape) - 1) if shape[d] % n_fsdp == 0 and shape[d] > 1]
        if rest:
            spec[max(rest, key=lambda d: shape[d])] = fsdp_axis
    return tuple(spec)


# ---------------------------------------------------------------------------
# channel tensor parallelism
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """All-gather the last dimension over the model group; the backward takes
    this rank's slice of the incoming gradient. Downstream of the gather
    every rank computes the same replicated function, so each already holds
    the whole gradient: a reduce-scatter would count it n times."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        x = x.contiguous()
        out = torch.empty((shard.n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=shard.group)
        out = out.view(shard.n, *x.shape).movedim(0, -2)
        return out.reshape(*x.shape[:-1], shard.n * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        c = g.shape[-1] // shard.n
        return g.narrow(-1, shard.rank * c, c).contiguous(), None


class _Enter(torch.autograd.Function):
    """The identity on a replicated input of a channel-parallel layer; the
    backward sums its gradient over the model group, each rank holding the
    part its channels give."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.shard.group)
        return g, None


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelShard:
    """A module's place in the model group: ``n`` ranks, this one ``rank``,
    each holding 1/n of the output channels of the weights in ``names``."""

    group: object
    n: int
    rank: int
    names: frozenset

    def whole_shape(self, local_shape) -> torch.Size:
        return torch.Size((*local_shape[:-1], local_shape[-1] * self.n))

    def gather(self, x):
        return _Gather.apply(x, self)

    def enter(self, x):
        return _Enter.apply(x, self)

    def local(self, whole):
        return whole.chunk(self.n, -1)[self.rank]


class _TPModule:
    """Mixed into a module whose weights are channel-sharded: reading
    ``module.<name>`` gives the whole weight, gathered (autograd records the
    gather); ``_parameters`` keep the slice (``named_parameters``,
    ``state_dict``, FSDP2). Between forwards under FSDP2 the slice is
    itself sharded (a DTensor), and the read gives it as it is."""

    def __getattr__(self, name):
        tp = self.__dict__.get("_tp")
        if tp is not None and name in tp.names:
            p = self._parameters[name]
            return p if is_dtensor(p) else tp.gather(p)
        return super().__getattr__(name)


_TP_CLASSES: dict = {}


def tp_shard_params(model: nn.Module, mesh: DeviceMesh, axis: str = "model",
                    min_size: int = 2**12) -> frozenset:
    """Keep this rank's slice of the last dimension of every parameter that
    ``tp_spec`` shards over ``axis``; returns their names. (The JAX
    function's ``fsdp_axis`` is FSDP2's part here: ``place_model``.)"""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    group, rank = mesh.get_group(axis), mesh.get_local_rank(axis)
    sharded = []
    for mod_name, mod in model.named_modules():
        names = frozenset(
            name for name, p in mod.named_parameters(recurse=False)
            if tp_spec(tuple(p.shape), n, axis, None, 1, min_size)[-1] == axis)
        if not names:
            continue
        shard = ChannelShard(group, n, rank, names)
        for name in names:
            whole = mod._parameters[name]
            mod._parameters[name] = nn.Parameter(shard.local(whole.detach()).clone(),
                                                 requires_grad=whole.requires_grad)
            sharded.append(f"{mod_name}.{name}" if mod_name else name)
        cls = type(mod)
        if cls not in _TP_CLASSES:
            _TP_CLASSES[cls] = type(f"TP{cls.__name__}", (_TPModule, cls), {})
        mod.__class__ = _TP_CLASSES[cls]
        mod._tp = shard
    return frozenset(sharded)


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------


def _blocks(model: nn.Module) -> list:
    from gddim_torch.models.blocks import AttnBlockpp, ResnetBlockBigGANpp

    return [m for m in model.modules() if isinstance(m, (ResnetBlockBigGANpp, AttnBlockpp))]


def fsdp_shard_params(model: nn.Module, mesh: DeviceMesh, min_size: int = 2**16,
                      axis: str = "data", placement_fn=None) -> nn.Module:
    """ZeRO-3 over ``axis`` through FSDP2: ``fully_shard`` on each residual
    and attention block and on the root, each leaf on the dimension
    ``fsdp_spec`` gives (``placement_fn(param) -> dim or None`` in its
    place). With more mesh axes than ``axis``, the axes before it replicate
    (HSDP); the gradients are averaged over the mesh."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in the mesh's {names}")
    keep = names[:names.index(axis) + 1]
    sub = mesh if keep == names else mesh[keep]
    n = mesh.size(names.index(axis))
    if placement_fn is None:
        def placement_fn(p):
            spec = fsdp_spec(tuple(p.shape), n, min_size, axis)
            return spec.index(axis) if axis in spec else None

    def shard_fn(p):
        dim = placement_fn(p)
        return None if dim is None else Shard(dim)

    for block in _blocks(model):
        fully_shard(block, mesh=sub, shard_placement_fn=shard_fn)
    fully_shard(model, mesh=sub, shard_placement_fn=shard_fn)
    return model


# ---------------------------------------------------------------------------
# batches and replication
# ---------------------------------------------------------------------------


def _index_over(mesh: DeviceMesh, axes) -> tuple[int, int]:
    coord = mesh.get_coordinate()
    idx, count = 0, 1
    for a in axes:
        i = mesh.mesh_dim_names.index(a)
        idx, count = idx * mesh.size(i) + coord[i], count * mesh.size(i)
    return idx, count


def shard_batch(batch, mesh: DeviceMesh, axes=None, dim: int = 0):
    """This rank's slice of a global batch (a tensor, array or dict of them)
    along ``dim``, split over ``axes`` (default: every axis but 'model')."""
    axes = [a for a in mesh.mesh_dim_names if a != "model"] if axes is None else axes
    idx, count = _index_over(mesh, axes)

    def one(x):
        if x.shape[dim] % count:
            raise ValueError(f"batch of {x.shape[dim]} does not split over {count} ranks")
        b = x.shape[dim] // count
        return x[(slice(None),) * dim + (slice(idx * b, (idx + 1) * b),)]

    return {k: one(v) for k, v in batch.items()} if isinstance(batch, dict) else one(batch)


@torch.no_grad()
def replicate_to_mesh(tensors, mesh: DeviceMesh):
    """Broadcast a module's parameters and buffers (or a dict or list of
    tensors) from the mesh's first rank and check that every rank held the
    same values already (states are made or restored alike on every rank).
    Returns ``tensors``."""
    if isinstance(tensors, nn.Module):
        items = list(tensors.state_dict(keep_vars=True).values())
    elif isinstance(tensors, dict):
        items = list(tensors.values())
    else:
        items = list(tensors)
    if mesh.size() == 1:
        return tensors
    if mesh.size() != process_count():
        raise ValueError("replicate_to_mesh: the mesh must span every rank")
    differ = torch.zeros((), dtype=torch.int32, device=items[0].device if items else "cpu")
    for t in items:
        t = local_tensor(t.detach())
        mine = t.clone()
        dist.broadcast(t, 0)
        differ += int(not torch.equal(mine, t))
    dist.all_reduce(differ)
    if int(differ):
        raise ValueError(f"replicate_to_mesh: {int(differ)} tensors differed between ranks")
    return tensors


# ---------------------------------------------------------------------------
# the placement of a training state
# ---------------------------------------------------------------------------

LAYOUTS = ("data", "fsdp", "tp", "fsdp_tp")


@dataclasses.dataclass(eq=False)
class Placement:
    """How a model and its training state lie on the ranks.

    ``kind``: 'data' (replicated, gradients averaged over the 1-D mesh),
    'fsdp' (FSDP2 over 'model' of the (data, model) mesh), 'tp' (channel TP
    over 'model', gradients averaged over 'data') or 'fsdp_tp' (FSDP2 over
    'fsdp' of the 3-D mesh, channel TP over 'model'). ``tp_names``: the
    channel-sharded parameters."""

    mesh: DeviceMesh
    kind: str
    tp_names: frozenset = frozenset()

    @property
    def fsdp_axis(self) -> str | None:
        return {"fsdp": "model", "fsdp_tp": "fsdp"}.get(self.kind)

    @property
    def tp_axis(self) -> str | None:
        return "model" if self.kind in ("tp", "fsdp_tp") else None

    @property
    def shards_state(self) -> bool:
        return self.kind != "data"

    @property
    def batch_axes(self) -> list:
        """The axes the batch splits over: every one but the TP axis."""
        return [a for a in self.mesh.mesh_dim_names if a != self.tp_axis]

    def batch_shard(self) -> tuple[int, int]:
        """(this rank's index, the count) of the batch's shards."""
        return _index_over(self.mesh, self.batch_axes)

    def shard_batch(self, batch, dim: int = 0):
        """This rank's rows of a global batch along ``dim``."""
        return shard_batch(batch, self.mesh, self.batch_axes, dim)

    def rows(self, generator, local_batch: int):
        """The generator of a training step on this rank's ``local_batch``
        rows: ``BatchRows`` of the global batch where it is split."""
        idx, count = self.batch_shard()
        if count == 1:
            return generator
        return BatchRows(generator, idx * local_batch, count * local_batch)

    def reduce_gradients(self, grads: list) -> None:
        """Average the gradients over the batch's ranks where FSDP2 does
        not: one flat all-reduce over 'data' (the replicated parameters of a
        TP run get the same gradient on every model rank, so 'data' is all
        they are averaged over)."""
        if self.fsdp_axis is not None or not grads:
            return
        group = self.mesh.get_group("data")
        n = dist.get_world_size(group)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        parts = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(parts, grads)])

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean of a scalar over every rank (the model group's ranks
        hold the same value)."""
        v = value.detach().float().reshape(1).clone()
        dist.all_reduce(v)
        return (v / dist.get_world_size())[0]

    def global_norm(self, names: list, grads: list) -> torch.Tensor:
        """The global gradient norm from this rank's shards: the squares of
        the channel-sharded leaves summed over 'model', the replicated ones
        counted once, then the FSDP shards summed over the FSDP axis; f64,
        rounded to f32 at the end."""
        sq = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64)) ** 2
        is_tp = torch.tensor([n in self.tp_names for n in names], device=sq.device)
        s_tp, s_rep = sq[is_tp].sum(), sq[~is_tp].sum()
        if self.tp_axis is not None:
            dist.all_reduce(s_tp, group=self.mesh.get_group(self.tp_axis))
        total = s_tp + s_rep
        if self.fsdp_axis is not None:
            dist.all_reduce(total, group=self.mesh.get_group(self.fsdp_axis))
        return total.sqrt().float()

    # whole tensors <-> this rank's shards (checkpoints, the EMA model)

    def full(self, model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from this rank's shard ``t``
        (the parameter itself, its EMA or a moment): a collective."""
        p = _param(model, name)
        if is_dtensor(p):
            from torch.distributed.tensor import DTensor

            t = DTensor.from_local(local_tensor(t), p.device_mesh, p.placements, shape=p.shape,
                                   stride=p.stride()).full_tensor()
        if name in self.tp_names:
            t = _module_of(model, name)._tp.gather(t.detach())
        return t.detach()

    def local(self, model: nn.Module, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of parameter ``name`` from its whole tensor."""
        p = _param(model, name)
        if name in self.tp_names:
            whole = _module_of(model, name)._tp.local(whole)
        if is_dtensor(p):
            from torch.distributed.tensor import Shard

            coord = p.device_mesh.get_coordinate()
            for i, pl in enumerate(p.placements):
                if isinstance(pl, Shard):
                    chunks = whole.chunk(p.device_mesh.size(i), pl.dim)
                    whole = (chunks[coord[i]] if coord[i] < len(chunks)
                             else whole.narrow(pl.dim, 0, 0))
            if whole.shape != local_tensor(p).shape:
                raise ValueError(f"{name}: shard {tuple(whole.shape)} against the "
                                 f"parameter's {tuple(local_tensor(p).shape)}")
        return whole

    def full_state_dict(self, model: nn.Module) -> dict:
        """``model.state_dict()`` with whole tensors (a collective)."""
        params = {n for n, _ in model.named_parameters()}
        return {k: self.full(model, k, v) if k in params else v
                for k, v in model.state_dict().items()}

    @torch.no_grad()
    def load_state_dict(self, model: nn.Module, sd: dict) -> None:
        """Copy whole tensors into this rank's shards, every key matching."""
        mine = dict(model.named_parameters())
        mine.update(model.named_buffers())
        if set(mine) != set(sd):
            raise KeyError(f"state_dict keys differ: {sorted(set(mine) ^ set(sd))[:5]}")
        for k, t in mine.items():
            src = self.local(model, k, sd[k]) if isinstance(t, nn.Parameter) else sd[k]
            local_tensor(t).copy_(src)


def _module_of(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rpartition(".")[0])


def _param(model: nn.Module, name: str):
    """The parameter object itself (a channel-sharded module's attribute
    reads the gathered whole)."""
    return _module_of(model, name)._parameters[name.rpartition(".")[2]]


def place_model(model: nn.Module, n_fsdp: int = 1, n_tp: int = 1, layout: str | None = None,
                device_type: str | None = None) -> tuple[nn.Module, Placement]:
    """Place ``model`` (on its device, alike on every rank) over the process
    group as ``gddim_tpu/run_lib.py:93-146`` places a state: ``n_fsdp`` and
    ``n_tp`` ranks from config.mesh, the rest of the world 'data';
    replicated (both 1), FSDP-sharded, TP-sharded or both. ``layout`` ('data',
    'fsdp', 'tp', 'fsdp_tp') takes that layout even where its axes have one
    rank (to run a parallel path alone). The weights are checked to be the
    same on every rank first. Returns (the model, its Placement)."""
    world = process_count()
    if world % (n_fsdp * n_tp):
        raise ValueError(f"{world} ranks do not split into fsdp {n_fsdp} x tp {n_tp}")
    n_data = world // (n_fsdp * n_tp)
    if layout is None:
        layout = {(False, False): "data", (True, False): "fsdp", (False, True): "tp",
                  (True, True): "fsdp_tp"}[(n_fsdp > 1, n_tp > 1)]
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    if layout == "data":
        mesh = make_mesh(world, device_type)
    elif layout == "fsdp":
        mesh = make_mesh_2d(n_data * n_tp, n_fsdp, device_type)
    elif layout == "tp":
        mesh = make_mesh_2d(n_data * n_fsdp, n_tp, device_type)
    else:
        mesh = make_mesh_3d(n_data, n_fsdp, n_tp, device_type)
    replicate_to_mesh(model, mesh)
    placement = Placement(mesh, layout)
    if layout in ("tp", "fsdp_tp"):
        placement.tp_names = tp_shard_params(model, mesh, axis="model")
    if layout == "fsdp":
        fsdp_shard_params(model, mesh, axis="model")
    elif layout == "fsdp_tp":
        tp_ids = {id(_param(model, n)) for n in placement.tp_names}

        def placement_fn(p):  # tp_spec's fsdp dimension, on the whole shape
            whole = (*p.shape[:-1], p.shape[-1] * n_tp) if id(p) in tp_ids else tuple(p.shape)
            spec = tp_spec(whole, n_tp, "model", "fsdp", n_fsdp)
            return spec.index("fsdp") if "fsdp" in spec else None

        fsdp_shard_params(model, mesh, axis="fsdp", placement_fn=placement_fn)
    return model, placement
