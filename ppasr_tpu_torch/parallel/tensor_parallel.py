"""Megatron tensor parallelism over the model axis of a (data, model) grid
(``parallel/mesh.py``), written with the ``torch.distributed`` core: the
collectives that GSPMD inserts for the JAX package's ``param_shardings(tp=
True)`` and ``shard_activation`` (ppasr_tpu/parallel/mesh.py:87-130,
models/attention.py:104-109, models/positionwise.py:45).

The primitives, autograd functions over a mesh's ``model_group``:

- ``copy_to_model``: identity forward, all-reduce backward. It opens each
  column-parallel block: every rank's shard of the block sends back only
  its part of the input's gradient;
- ``reduce_from_model``: all-reduce forward, identity backward. It closes
  the row-parallel layer of the block (its bias is added once, after);
- ``gather_from_model``: a weight stored as a shard, all-gathered at use
  (the table's fallback leaves: the subsampling convs, the CTC head, the
  decoder's embedding and output layer, the Squeezeformer's time
  reduction). Its backward takes this rank's slice of the full gradient,
  which every peer computes alike from replicated inputs;
- ``slice_of_replicated``: this rank's channels of a replicated parameter
  used inside a sharded region (the conv module's depthwise bias and
  norm), whose backward all-gathers the slices' gradients, so that every
  peer holds the whole gradient.

So a self-attention, feed-forward or convolution block makes exactly one
all-reduce forward and one backward (the conv module's LayerNorm adds one
pair of its own for its statistics over the whole channel vector).

``shard_module(model, mesh)`` applies this in place to a built model with
its whole weights: each parameter becomes this rank's shard by
``mesh.param_specs``/``shard_params`` (through ``utils/checkpoint``'s
flax mapping), the attention computes ``n_head / n_model`` heads, the
feed-forward ``linear_units / n_model`` hidden units, the conv module its
channel slice, and the layers take the classes below (a ``__class__``
swap: the module keeps its parameters and hooks). Dropouts over sharded
activations are marked ``sharded``: the train step gives them a stream
that folds in the model index, while the replicated regions' stream
folds in the data index only, so that model peers draw one mask there
and their replicated parameters stay equal; the train step also copies
model index 0's gradients of the replicated parameters to its peers
(``sync_replicated_grads``), since kernels that add in no fixed order
round the peers' copies apart on the card.

DeepSpeech2 is held replicated over the model axis: its recurrent kernels
are flax's per-gate kernels stacked into ``nn.LSTM``/``nn.GRU`` weights,
and the table's shards of them are not rows of those weights.
``gather_params`` reads a sharded model back as the whole flax tree.
"""
import torch
import torch.distributed as dist
from torch.nn import functional as F

from ppasr_tpu_torch.models.base import (BatchNorm, Conv1d, Conv2d, Embedding,
                                         LayerNorm, Linear)
from ppasr_tpu_torch.parallel.distributed import (all_gather,
                                                  all_gather_object,
                                                  all_reduce_sum,
                                                  all_reduce_sum_with_grad)
from ppasr_tpu_torch.parallel.mesh import (param_specs, shard_params,
                                           unshard_params)


def _on(mesh) -> bool:
    return mesh is not None and mesh.n_model > 1


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, index, group):
        ctx.dim, ctx.index, ctx.size = dim, index, w.shape[dim]
        return all_gather(w, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
                .contiguous(), None, None, None)


class _SliceOfReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, index, n, group):
        ctx.dim, ctx.group = dim, group
        size = w.shape[dim] // n
        return w.narrow(dim, index * size, size).clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.dim, ctx.group), None, None, None, None


def copy_to_model(x, mesh):
    """Into a sharded region: identity, all-reduce of the gradient."""
    return _CopyToModel.apply(x, mesh.model_group) if _on(mesh) else x


def reduce_from_model(x, mesh):
    """Out of a sharded region: the model ranks' partial sums added."""
    return _ReduceFromModel.apply(x, mesh.model_group) if _on(mesh) else x


def gather_from_model(w, dim: int, mesh):
    """The whole weight from this rank's shard along ``dim``."""
    return _GatherFromModel.apply(w, dim, mesh.model_index,
                                  mesh.model_group)


def slice_of_replicated(w, dim: int, mesh):
    """This rank's slice along ``dim`` of a replicated parameter."""
    return _SliceOfReplicated.apply(w, dim, mesh.model_index, mesh.n_model,
                                    mesh.model_group)


class RowParallelLinear(Linear):
    """A ``Linear`` whose weight holds this rank's input features: the
    partial products are reduced over the model group, then the
    (replicated) bias is added once."""

    def forward(self, x):
        x, weight, bias = self._cast(x)
        y = reduce_from_model(F.linear(x, weight), self.tp)
        return y if bias is None else y + bias


class _Gathered:
    """A layer whose weight is stored as a shard along ``tp_dim`` and
    gathered at each call."""

    def _weight(self):
        return gather_from_model(self.weight, self.tp_dim, self.tp)


class GatheredLinear(_Gathered, Linear):
    pass


class GatheredConv1d(_Gathered, Conv1d):
    pass


class GatheredConv2d(_Gathered, Conv2d):
    pass


class GatheredEmbedding(_Gathered, Embedding):
    pass


GATHERED = {Linear: GatheredLinear, Conv1d: GatheredConv1d,
            Conv2d: GatheredConv2d, Embedding: GatheredEmbedding}


class ShardedDepthwiseConv1d(Conv1d):
    """The conv module's depthwise conv over this rank's channels: the
    kernel is a shard, the replicated bias sliced at use."""

    def _bias(self):
        return slice_of_replicated(self.bias, 0, self.tp)


class ShardedLayerNorm(LayerNorm):
    """LayerNorm over the whole channel vector of activations whose
    channels are sharded: each row's sum and sum of squares, in float32,
    are all-reduced over the model group (backward too) before this rank
    normalizes its channels with its slice of the replicated affine."""

    def forward(self, x):
        xf = x.float()
        c = self.normalized_shape[0]
        sums = all_reduce_sum_with_grad(
            torch.stack([xf.sum(-1), (xf * xf).sum(-1)], dim=-1),
            self.tp.model_group)
        mean = sums[..., :1] / c
        var = sums[..., 1:] / c - mean * mean
        y = (xf - mean) * torch.rsqrt(var + self.eps) \
            * slice_of_replicated(self.weight, 0, self.tp) \
            + slice_of_replicated(self.bias, 0, self.tp)
        return y.to(x.dtype)


class ShardedBatchNorm(BatchNorm):
    """BatchNorm over this rank's channels: moments over ``stats_group``
    (the data group), the replicated affine and running statistics sliced,
    the statistics' update all-gathered over the model group so that every
    peer keeps the whole vectors alike."""

    def _slice(self, t):
        size = t.shape[0] // self.tp.n_model
        return t.narrow(0, self.tp.model_index * size, size)

    def _update_running(self, mean, var):
        group = self.tp.model_group
        super()._update_running(all_gather(mean, 0, group),
                                all_gather(var, 0, group))

    def _running(self):
        return self._slice(self.running_mean), self._slice(self.running_var)

    def _affine(self):
        return (slice_of_replicated(self.weight, 0, self.tp),
                slice_of_replicated(self.bias, 0, self.tp))


def _swap(module, cls, mesh):
    module.__class__ = cls
    module.tp = mesh


def _require(cond, what):
    if not cond:
        raise ValueError(f"tensor parallelism: {what}")


def shard_module(model, mesh):
    """Shard ``model`` (whole weights, any device) in place over
    ``mesh``'s model axis (see the module docstring). Every rank of the
    model group calls it on the same weights. Returns the model."""
    from ppasr_tpu_torch.models.attention import MultiHeadedAttention
    from ppasr_tpu_torch.models.convolution import ConvolutionModule
    from ppasr_tpu_torch.models.deepspeech2 import DeepSpeech2Model
    from ppasr_tpu_torch.models.efficient_conformer import (
        GroupedRelPositionAttention, StridedConvolutionModule)
    from ppasr_tpu_torch.models.positionwise import PositionwiseFeedForward
    from ppasr_tpu_torch.utils.checkpoint import convert_params, export_params
    n = mesh.n_model
    model.tp_mesh = mesh
    if n == 1 or isinstance(model, DeepSpeech2Model):
        return model
    whole = export_params(model)
    model.tp_specs = param_specs(whole, n)
    local = convert_params(shard_params(whole, n, mesh.model_index))
    with torch.no_grad():
        for name, p in model.named_parameters():
            shard = local[name]
            if shard.shape != p.shape:
                p.tp_dim = next(d for d, (a, b) in enumerate(
                    zip(shard.shape, p.shape)) if a != b)
                p.data = shard.to(device=p.device, dtype=p.dtype)

    def sharded(layer, dim):
        return getattr(layer.weight, 'tp_dim', None) == dim

    column = set()      # the blocks' column-parallel layers, used as shards
    for name, m in model.named_modules():
        if isinstance(m, (MultiHeadedAttention, GroupedRelPositionAttention)):
            _require(m.n_head % n == 0 and sharded(m.linear_q, 0)
                     and sharded(m.linear_out, 1),
                     f"{name}: {m.n_head} heads over {n} ranks")
            m.tp, m.n_head, m.n_feat = mesh, m.n_head // n, m.n_feat // n
            column.update(id(getattr(m, k)) for k in (
                'linear_q', 'linear_k', 'linear_v', 'linear_pos')
                if hasattr(m, k))
            m.dropout.sharded = True
            _swap(m.linear_out, RowParallelLinear, mesh)
        elif isinstance(m, PositionwiseFeedForward):
            _require(sharded(m.w_1, 0) and sharded(m.w_2, 1),
                     f"{name}: {m.w_1.out_features} units over {n} ranks")
            m.tp = mesh
            m.dropout.sharded = True
            column.add(id(m.w_1))
            _swap(m.w_2, RowParallelLinear, mesh)
        elif isinstance(m, (ConvolutionModule, StridedConvolutionModule)) \
                and hasattr(m, 'pointwise_conv1'):
            dw = m.depthwise_conv
            _require(sharded(m.pointwise_conv1, 0) and sharded(dw, 0)
                     and sharded(m.pointwise_conv2, 1),
                     f"{name}: {dw.in_channels} channels over {n} ranks")
            m.tp = mesh
            column.add(id(m.pointwise_conv1))
            _swap(m.pointwise_conv2, RowParallelLinear, mesh)
            _swap(dw, ShardedDepthwiseConv1d, mesh)
            dw.groups = dw.weight.shape[0]
            _swap(m.norm, ShardedBatchNorm if isinstance(m.norm, BatchNorm)
                  else ShardedLayerNorm, mesh)
    for m in model.modules():
        cls = GATHERED.get(type(m))
        dim = getattr(getattr(m, 'weight', None), 'tp_dim', None)
        if cls is not None and dim is not None and id(m) not in column:
            _swap(m, cls, mesh)
            m.tp_dim = dim
    return model


def is_sharded(p) -> bool:
    """Whether a parameter holds a shard (``shard_module``)."""
    return getattr(p, 'tp_dim', None) is not None


@torch.no_grad()
def sync_replicated_grads(params, mesh):
    """Model index 0's gradients of the replicated parameters, copied to
    its model peers (one broadcast). The peers compute them from the same
    inputs, but a kernel that adds in no fixed order (the CTC emissions'
    ``scatter_add_`` over the repeated blank, atomic on the card) rounds
    them apart, and the replicas would drift."""
    grads = [p.grad for p in params if not is_sharded(p)]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.broadcast(flat, src=mesh.data_index * mesh.n_model,
                   group=mesh.model_group)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def gather_params(model) -> dict:
    """The whole flax tree of a model that ``shard_module`` sharded (the
    model ranks' ``export_params`` gathered over the model group; every
    peer calls it), or of any other model."""
    from ppasr_tpu_torch.utils.checkpoint import export_params
    tree = export_params(model)
    specs = getattr(model, 'tp_specs', None)
    if specs is None:
        return tree
    return unshard_params(all_gather_object(tree, model.tp_mesh.model_group),
                          specs)
