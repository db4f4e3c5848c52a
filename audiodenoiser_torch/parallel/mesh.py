"""The ('data', 'model') device mesh and its sharding rule (port of
``parallel/mesh.py``).

The JAX package lays a 2-D ``Mesh(('data', 'model'))`` over its chips:
``data`` shards the batch (XLA inserts the gradient all-reduce) and
``model`` shards the output channels of the wide convolution kernels
(channel tensor parallelism). Here the mesh is a ``DeviceMesh`` over the
process group's ranks, one rank per card, and the layout is applied to
the modules themselves:

- ``param_spec`` is JAX's rule restated for torch layouts: a conv's output
  channels shard over ``model`` and, under fsdp, its input channels over
  ``data``, each when it divides evenly and is at least 128; a 1-D leaf of
  at least 128 that divides evenly shards over ``model``. Torch ``Conv2d``
  kernels are (cout, cin, kh, kw), ``ConvTranspose2d`` kernels (cin, cout,
  kh, kw).
- ``shard_model`` cuts each wide layer of a ``UNet`` (every ``DoubleConv``
  conv with its BatchNorm, every upsampling; the folded convs of a
  ``FoldedUNet``) down to this model rank's output-channel slice and makes
  it column-parallel (``parallel.layers``); the head, the refinement path
  and the attention block stay whole on every rank. In train mode every
  BatchNorm takes the data group's statistics (with one data rank its own
  batch is the global one, and BatchNorm runs as unmeshed, so a
  world-size-1 mesh steps as the unmeshed program does). With ``fsdp`` FSDP2's
  ``fully_shard`` shards each wide layer's slice over ``data`` on its
  input channels, and then the rest of the model over ``data`` on dim 0:
  FSDP2 shards every parameter it manages, so the narrow ones (biases,
  BatchNorm) go to 1/dp as well, where JAX keeps them whole.
- ``shard_train_state`` applies the layout to a ``TrainState``: the
  parameters, the BatchNorm statistics and the AdamW moments (and the
  gradients summed between micro-steps), cut from full tensors, so a
  state restored from any layout lands on this one. ``shard_variables``
  is the inference layout (no fsdp).
- ``Layout`` knows each tensor's sharded dims: it gathers full tensors for
  exports and the resume state (``full_state_dict``, ``full_optimizer_state``;
  collectives every rank calls, rank 0 writes), averages the replicated
  gradients over ``data``, and takes the global gradient norm with each
  sharded leaf's squares summed over the groups that shard it.
- ``shard_batch`` keeps this data rank's contiguous block of rows.

Every collective runs on the mesh's groups even at world size 1, so the
one card runs the meshed program that a bigger world runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from audiodenoiser_torch.device import DeviceLike
from audiodenoiser_torch.parallel import distributed
from audiodenoiser_torch.parallel.layers import TensorParallel

DATA_AXIS = "data"
MODEL_AXIS = "model"
MIN_SHARDED = 128  # narrower channel dims stay whole: not worth a collective


def mesh_shape(n_devices: int, model_parallel: Optional[int] = None) -> tuple[int, int]:
    """(data, model) sizes of a mesh over ``n_devices``: ``model_parallel``
    defaults to 2 when the count is even and above 1, else 1."""
    if model_parallel is None:
        model_parallel = 2 if (n_devices > 1 and n_devices % 2 == 0) else 1
    if n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by model_parallel={model_parallel}")
    return n_devices // model_parallel, model_parallel


_MESHES: dict = {}


def make_mesh(n_devices: Optional[int] = None, model_parallel: Optional[int] = None,
              device: DeviceLike = None):
    """A 2-D ``DeviceMesh`` named ``('data', 'model')`` over the first
    ``n_devices`` ranks of the process group (default all; the launcher's
    group, or a world-size-1 group of this process), rank r at
    (r // model_parallel, r % model_parallel): consecutive ranks, a node's
    cards under ``torchrun``, share a data row. ``device`` picks the
    group's backend (None: the card). Every rank of the group calls it; a
    rank past ``n_devices`` gets a mesh it is not part of
    (``mesh.get_coordinate()`` is None)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    kind = distributed.ensure_process_group(device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"asked for a mesh of {n} devices; the process group has {world}")
    shape = mesh_shape(n, model_parallel)
    key = (kind, n, shape)
    if key not in _MESHES:
        names = (DATA_AXIS, MODEL_AXIS)
        _MESHES[key] = (init_device_mesh(kind, shape, mesh_dim_names=names) if n == world
                        else DeviceMesh(kind, torch.arange(n).reshape(shape),
                                        mesh_dim_names=names))
    return _MESHES[key]


def mesh_sizes(mesh) -> tuple[int, int]:
    return mesh.size(0), mesh.size(1)


def _transposed(name: str) -> bool:
    """A ``ConvTranspose2d`` kernel by its name: the U-Net's ``upconv{k}.up``,
    the folded ``convs.up{i}_deconv``."""
    return name.endswith(".up.weight") or "_deconv." in name


def param_spec(name: str, shape, model_size: int, fsdp_size: int = 1,
               transposed: Optional[bool] = None) -> tuple:
    """The mesh axis of each dim of one tensor ('model', 'data' or None),
    JAX's ``_param_spec`` for torch layouts. ``transposed`` (default: read
    from ``name``) marks a (cin, cout, kh, kw) ``ConvTranspose2d`` kernel."""
    shape = tuple(shape)
    spec = [None] * len(shape)
    if len(shape) == 4:
        if transposed is None:
            transposed = _transposed(name)
        cout, cin = (1, 0) if transposed else (0, 1)
        if model_size > 1 and shape[cout] % model_size == 0 and shape[cout] >= MIN_SHARDED:
            spec[cout] = MODEL_AXIS
        if fsdp_size > 1 and shape[cin] % fsdp_size == 0 and shape[cin] >= MIN_SHARDED:
            spec[cin] = DATA_AXIS
    elif (len(shape) == 1 and model_size > 1 and shape[0] % model_size == 0
          and shape[0] >= MIN_SHARDED):
        spec[0] = MODEL_AXIS
    return tuple(spec)


def param_shardings(model: nn.Module, mesh, fsdp: bool = False) -> dict:
    """``param_spec`` of every tensor of ``model``'s (full) state dict, by
    name: the layout ``shard_model`` gives the wide layers."""
    dp, tp = mesh_sizes(mesh)
    return {name: param_spec(name, t.shape, tp, dp if fsdp else 1)
            for name, t in model.state_dict().items()}


def batch_sharding(mesh, ndim: int = 4) -> tuple:
    """The batch's layout: dim 0 over ``data``, the rest whole."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


@dataclass
class Layout:
    """How one model lies on a mesh: the model-sharded dim of each tensor
    by state-dict name (parameters and BatchNorm statistics) and the
    groups; an FSDP2 parameter says its data-sharded dim itself."""

    mesh: object
    model_dims: dict = field(default_factory=dict)

    def __post_init__(self):
        self.dp, self.tp = mesh_sizes(self.mesh)
        self.data_group = self.mesh.get_group(DATA_AXIS)
        self.model_group = self.mesh.get_group(MODEL_AXIS)
        self.model_rank = self.mesh.get_local_rank(MODEL_AXIS)

    @property
    def tensor_parallel(self) -> Optional[TensorParallel]:
        if self.tp == 1:
            return None
        return TensorParallel(self.model_group, self.tp, self.model_rank)

    def cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This model rank's slice of a full tensor."""
        dim = self.model_dims.get(name)
        if dim is None:
            return full
        part = full.detach().chunk(self.tp, dim)[self.model_rank]
        if part.dim() == 4:
            return part.contiguous(memory_format=torch.channels_last)
        return part.contiguous()

    def shard_like(self, name: str, full: torch.Tensor, like) -> torch.Tensor:
        """``full`` laid out as ``like``, a tensor of this layout: cut to
        the model slice and, for an FSDP2 ``DTensor``, to this data rank's
        chunk of it."""
        part = self.cut(name, full).to(like.device, like.dtype)
        if not hasattr(like, "placements"):
            return part
        from torch.distributed.tensor import DTensor

        (placement,) = like.placements
        mesh = like.device_mesh
        chunks, r = part.chunk(mesh.size(), placement.dim), mesh.get_local_rank()
        # FSDP2's uneven layout: torch.chunk's pieces, then empty ones
        chunk = chunks[r] if r < len(chunks) else part.narrow(placement.dim, 0, 0)
        return DTensor.from_local(chunk.contiguous(), mesh, like.placements,
                                  shape=like.shape, stride=like.stride(), run_check=False)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of a sharded one (a collective on every rank)."""
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        t = t.detach()
        dim = self.model_dims.get(name)
        if dim is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.all_gather(parts, t, group=self.model_group)
        return torch.cat(parts, dim)

    def full_state_dict(self, model: nn.Module, overrides: Optional[dict] = None) -> dict:
        """``model.state_dict()`` with full tensors, ``overrides`` (name ->
        sharded tensor, e.g. an EMA) in place of its parameters."""
        sd = model.state_dict()
        sd.update(overrides or {})
        return {k: self.full(k, v) for k, v in sd.items()}

    def sync_grads(self, params: list) -> None:
        """Average the gradients FSDP2 does not reduce (every parameter
        without fsdp) over the data group, in one flat bucket."""
        grads = [p.grad for p in params if p.grad is not None and not hasattr(p.grad, "to_local")]
        if not grads:
            return
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=self.data_group)
        flat.div_(self.dp)
        torch._foreach_copy_(grads, torch._utils._unflatten_dense_tensors(flat, grads))

    def global_norm(self, params: list, local_grads: list, names: list) -> torch.Tensor:
        """The 2-norm of the whole gradient: each local shard's squares,
        summed over the model group for the model-sharded leaves and over
        the data group for the FSDP2 ones; a replicated leaf counts once."""
        sq = torch.stack(torch._foreach_norm(local_grads)).square()
        model_sh = torch.tensor([n in self.model_dims for n in names], device=sq.device)
        data_sh = torch.tensor([hasattr(p, "to_local") for p in params], device=sq.device)
        parts = torch.stack([(sq * (~model_sh & ~data_sh)).sum(),
                             (sq * (model_sh & ~data_sh)).sum(),
                             (sq * (~model_sh & data_sh)).sum(),
                             (sq * (model_sh & data_sh)).sum()])
        over_model = parts[[1, 3]].contiguous()
        dist.all_reduce(over_model, group=self.model_group)
        over_data = torch.stack([parts[2], over_model[1]])
        dist.all_reduce(over_data, group=self.data_group)
        return torch.sqrt(parts[0] + over_model[0] + over_data.sum())


def _wide_layers(model: nn.Module):
    """(conv name, conv, BatchNorm name or None, BatchNorm) for each layer
    that may be column-parallel: every ``DoubleConv`` conv with its
    BatchNorm and every upsampling of a ``UNet``, every folded conv of a
    ``FoldedUNet`` but the head and the refinement path."""
    from audiodenoiser_torch.models.folded import FoldedUNet
    from audiodenoiser_torch.models.unet import DoubleConv, Up, UNet

    if isinstance(model, FoldedUNet):
        for key, conv in model.convs.items():
            if key != "out" and not key.startswith("s2d_"):
                yield f"convs.{key}", conv, None, None
        return
    if not isinstance(model, UNet):
        raise TypeError(f"a mesh lays out a UNet or a FoldedUNet, not {type(model).__name__}")
    for name, m in model.named_modules():
        if isinstance(m, DoubleConv):
            seq = m.double_conv
            for c, b in ((0, 1), (3, 4)):
                yield (f"{name}.double_conv.{c}", seq[c], f"{name}.double_conv.{b}", seq[b])
        elif isinstance(m, Up):
            yield f"{name}.up", m.up, None, None


def _set(module: nn.Module, attr: str, value: torch.Tensor) -> None:
    if attr in module._parameters:
        module._parameters[attr] = nn.Parameter(value, requires_grad=module._parameters[attr].requires_grad)
    else:
        module._buffers[attr] = value


def shard_model(model: nn.Module, mesh, fsdp: bool = False) -> Layout:
    """Lay ``model`` (a ``UNet`` or ``FoldedUNet``, its full weights on
    this rank's device) out on ``mesh`` in place and return its layout."""
    from audiodenoiser_torch.models.unet import BatchNorm2d, ConvTranspose2x2

    if getattr(model, "mesh_layout", None) is not None:
        raise ValueError("this model is already laid out on a mesh")
    layout = Layout(mesh)
    tp = layout.tensor_parallel
    for conv_name, conv, bn_name, bn in _wide_layers(model):
        transposed = isinstance(conv, nn.ConvTranspose2d) or getattr(conv, "transpose", False)
        spec = param_spec(f"{conv_name}.weight", conv.weight.shape, layout.tp,
                          transposed=transposed)
        if MODEL_AXIS not in spec:
            continue
        layout.model_dims[f"{conv_name}.weight"] = spec.index(MODEL_AXIS)
        layout.model_dims[f"{conv_name}.bias"] = 0
        if bn is not None:
            for attr in ("weight", "bias", "running_mean", "running_var"):
                layout.model_dims[f"{bn_name}.{attr}"] = 0
        for prefix, module in ((conv_name, conv), (bn_name, bn)):
            if module is None:
                continue
            for attr in ("weight", "bias", "running_mean", "running_var"):
                key = f"{prefix}.{attr}"
                if key in layout.model_dims and getattr(module, attr, None) is not None:
                    _set(module, attr, layout.cut(key, getattr(module, attr)))
        conv.tp = tp
    if layout.dp > 1:  # one data rank's batch is the global batch: BatchNorm as unmeshed
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.data_group = layout.data_group
    if fsdp:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        data_mesh = mesh[DATA_AXIS]
        with torch.no_grad():  # FSDP2 shards contiguous parameters only
            for p in model.parameters():
                p.data = p.data.contiguous()
        for conv_name, conv, _, _ in _wide_layers(model):
            transposed = isinstance(conv, nn.ConvTranspose2d)
            spec = param_spec(f"{conv_name}.weight", conv.weight.shape, 1, layout.dp,
                              transposed=transposed)
            if DATA_AXIS not in spec:
                continue
            cin = spec.index(DATA_AXIS)
            fully_shard(conv, mesh=data_mesh,
                        shard_placement_fn=lambda p, cin=cin: Shard(cin if p.dim() == 4 else 0))
            if isinstance(conv, ConvTranspose2x2):
                conv.repack = True
        fully_shard(model, mesh=data_mesh)
    model.mesh_layout = layout
    return layout


def shard_variables(model: nn.Module, mesh) -> nn.Module:
    """The inference layout (JAX ``shard_variables``): ``model`` laid out
    on ``mesh`` without fsdp, in place; a model laid out already is
    returned as it is."""
    if getattr(model, "mesh_layout", None) is None:
        shard_model(model, mesh)
    return model


def shard_train_state(state, mesh, fsdp: bool = False):
    """A ``train.loop.TrainState`` laid out on ``mesh``: the model in place
    (``shard_model``) and a new optimizer over its sharded parameters with
    the old one's moments, step counts and summed gradients cut to match."""
    from audiodenoiser_torch.train.loop import ClippedAdamW, TrainState

    old = state.optimizer
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    by_name = dict(zip(names, old.params))
    moments = {n: old.adamw.state.get(p, {}) for n, p in by_name.items()}
    grads = {n: p.grad for n, p in by_name.items()} if old.micro_step else {}
    group = old.adamw.param_groups[0]
    layout = shard_model(state.model, mesh, fsdp=fsdp)
    new_params = dict(state.model.named_parameters())
    tx = ClippedAdamW([new_params[n] for n in names], group["lr"], group["weight_decay"],
                      old.clip_norm, old.schedule, old.grad_accum, layout=layout, names=names)
    tx.updates, tx.micro_step = old.updates, old.micro_step
    with torch.no_grad():
        for n in names:
            p = new_params[n]
            st = moments[n]
            if st:
                tx.adamw.state[p] = {k: (layout.shard_like(n, v, p) if v.dim() else v.clone())
                                     for k, v in st.items()}
            if grads.get(n) is not None:
                p.grad = layout.shard_like(n, grads[n], p)
    return TrainState(model=state.model, optimizer=tx, step=state.step,
                      grad_norm=state.grad_norm, layout=layout)


def full_optimizer_state(state) -> dict:
    """``state.optimizer.state_dict()`` with full tensors (a collective on
    every rank), indexed as the unsharded optimizer's."""
    opt, layout = state.optimizer, state.layout
    sd = opt.state_dict()
    index = {id(p): i for i, p in enumerate(opt.params)}
    adamw_state = {}
    for p, st in opt.adamw.state.items():
        i = index[id(p)]
        name = opt.names[i]
        adamw_state[i] = {k: (layout.full(name, v) if torch.is_tensor(v) and v.dim() else v)
                          for k, v in st.items()}
    sd["adamw"] = {**sd["adamw"], "state": adamw_state}
    if opt.micro_step:
        sd["grads"] = [None if p.grad is None else layout.full(n, p.grad)
                       for n, p in zip(opt.names, opt.params)]
    return sd


def shard_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's contiguous block of the rows of ``x``, whose first
    dim the data axis divides."""
    dp = mesh.size(0)
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} rows does not divide over {dp} data ranks")
    b = x.shape[0] // dp
    r = mesh.get_local_rank(DATA_AXIS)
    return x[r * b:(r + 1) * b]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The data ranks' blocks of rows concatenated in rank order (every
    rank gets the whole batch)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(0))]
    dist.all_gather(parts, x, group=mesh.get_group(DATA_AXIS))
    return torch.cat(parts, dim=0)
