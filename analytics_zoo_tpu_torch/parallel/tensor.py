"""Tensor (model) parallelism: the reference's sharding rules, and the
layers that run a sharded weight (counterpart of ``parallel/tensor.py``).

The rules are the reference's: ``(path_regex, spec_fn)`` pairs matched
against a parameter's flax path (``params/vgg/conv1_1/kernel``), whose
``spec_fn`` names a mesh axis for each dim of the flax-layout shape.  A
port parameter resolves through ``utils/convert.py``: its flax key
(``flax_key``) selects the rule, and ``flax_dim_order`` carries the
flax dims onto the torch layout, so "output features" is dim 0 of a
``Linear`` (out, in) or ``Conv2d`` (out, in, kh, kw) weight and "vocab
rows" dim 0 of a (vocab, dim) table.  A dim that does not divide its
axis stays replicated.

PyTorch has no SPMD partitioner, so this module also does what XLA does
for the reference.  :func:`shard_module` keeps each rank's shard of every
matched parameter (its spec, axis and full shape in this module's side
table, :func:`shard_of`) and turns each layer that owns a sharded
weight into its parallel subclass (the class swap that
``torch.nn.utils.parametrize`` also makes), so the layers of ``core/``,
``ops/`` and ``models/`` know nothing of the mesh:

- a **column** layer (output features sharded) computes its output
  channels' slice; the slice stays sharded where the rule pairs the
  layer with row consumers (``megatron_tp_rules``, which
  ``ssd_tp_rules`` builds), else it is all-gathered
  (``default_tp_rules``);
- a **row** layer (contraction sharded) contracts its input channels'
  slice, taking a sharded input as it comes and slicing a replicated
  one, all-reduces over the axis and adds its bias once;
- SSD's ``NormalizeScale`` on a sharded conv4_3 all-reduces its sum of
  squares and slices its scale;
- a row-sharded ``DedupEmbed`` looks up the ids its shard owns (the
  others masked to zero rows) and sums the ranks' rows over the axis;
- the collectives are autograd functions with the conjugate backward:
  all-reduce ↔ identity, all-gather ↔ slice.

A sharded weight read outside its layer's forward (the persistent-RNN
kernels' h2h weight, a functional convolution) goes through
``utils.spmd.whole``, for which placement registers :func:`gathered`:
it arrives gathered whole, and its gradient leaves sliced to the shard.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

from analytics_zoo_tpu_torch.core.layers import NormalizeScale
from analytics_zoo_tpu_torch.ops.embedding import (DedupEmbed, SparseRows,
                                                   sharded_embedding_lookup)
from analytics_zoo_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                   PartitionSpec as P,
                                                   axis_group, axis_index,
                                                   axis_names, axis_size)
from analytics_zoo_tpu_torch.utils import spmd
from analytics_zoo_tpu_torch.utils.convert import flax_dim_order, flax_key

logger = logging.getLogger("analytics_zoo_tpu_torch")

# rule: (path_regex, spec_fn(flax shape) -> axis per flax dim)
Rule = Tuple[str, Callable[[Tuple[int, ...]], Sequence[Optional[str]]]]


def _last_dim(axis: str, keep_sharded: bool = False):
    """Shard the trailing (output-feature) flax dim — Dense kernels (in,
    out), Conv kernels (kh, kw, cin, cout), Embed tables (vocab,
    features).  ``keep_sharded``: the layer's consumers are row layers
    (a Megatron pair), so its output stays sharded."""
    def spec(shape):
        return [None] * (len(shape) - 1) + [axis]
    spec.keep_sharded = keep_sharded
    return spec


def _contract_dim(axis: str):
    """Shard the contraction (input-feature) flax dim — dim 0 of a Dense
    (in, out) kernel, dim -2 of a Conv (kh, kw, cin, cout) kernel: the
    row-parallel half, one all-reduce after."""
    def spec(shape):
        axes: List[Optional[str]] = [None] * len(shape)
        axes[0 if len(shape) <= 2 else len(shape) - 2] = axis
        return axes
    return spec


def _row_dim(axis: str):
    """Shard dim 0 — the vocab dim of a (vocab, features) table: each
    rank owns a contiguous id range."""
    def spec(shape):
        axes: List[Optional[str]] = [None] * len(shape)
        axes[0] = axis
        return axes
    return spec


def embedding_row_rules(axis: str = MODEL_AXIS) -> List[Rule]:
    """Row-shard every ``embedding`` table over ``axis`` (vocab dim 0)."""
    return [(r"(^|.*/)embedding$", _row_dim(axis))]


def default_tp_rules(axis: str = MODEL_AXIS) -> List[Rule]:
    """Column sharding of every kernel's output features (outputs
    all-gathered); tables take the row rule first; biases and scales
    stay replicated."""
    return embedding_row_rules(axis) + [(r"(^|.*/)kernel$", _last_dim(axis))]


def megatron_tp_rules(col: Sequence[str], row: Sequence[str],
                      axis: str = MODEL_AXIS) -> List[Rule]:
    """Paired column/row rules from two lists of layer names: ``col``
    layers shard output features and their activations leave sharded,
    ``row`` layers shard the contraction and emit a replicated output
    after one all-reduce.  Names match any path component."""
    def name_rule(names: Sequence[str], spec_fn) -> Rule:
        alt = "|".join(re.escape(n) for n in names)
        return (rf"(^|.*/)({alt})/(kernel|embedding)$", spec_fn)

    return [name_rule(col, _last_dim(axis, keep_sharded=True)),
            name_rule(row, _contract_dim(axis))]


def ssd_tp_rules(axis: str = MODEL_AXIS,
                 resolution: int = 300) -> List[Rule]:
    """The reference's Megatron pairing of the SSDVgg topology: every
    layer whose output feeds a sharded conv or a detection head is a
    column layer, its consumers (every ``loc_*``/``conf_*`` head among
    them) are row layers, so head outputs come back replicated."""
    col = ["conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_3",
           "conv5_2", "fc7", "conv6_2", "conv7_2", "conv8_2", "conv9_2"]
    row = ["conv1_2", "conv2_2", "conv3_2", "conv3_3", "conv4_2",
           "conv5_1", "conv5_3", "fc6", "conv6_1", "conv7_1", "conv8_1",
           "conv9_1", "loc_0", "loc_1", "loc_2", "loc_3", "loc_4", "loc_5",
           "conf_0", "conf_1", "conf_2", "conf_3", "conf_4", "conf_5"]
    if resolution != 300:
        col.append("conv10_2")
        row += ["conv10_1", "loc_6", "conf_6"]
    return megatron_tp_rules(col, row, axis)


def spatial_input_spec(axis: str = MODEL_AXIS,
                       data_axis_name: str = DATA_AXIS) -> P:
    """NHWC image batches with the height over ``axis`` (spatial
    partitioning), the parameters replicated: ``shard_batch`` keeps a
    rank's block of the rows (``mesh.row_block``), and the forward runs
    in ``utils.spmd.row_shards``, fetching each layer's halo rows
    (``models.ssd.spatial_forward``)."""
    return P(data_axis_name, axis, None, None)


def rule_axes(rules: Sequence[Rule]) -> frozenset:
    """Mesh-axis names a rule set can resolve to (each spec builder
    probed at leaf ranks 1..4)."""
    axes = set()
    for _, spec_fn in rules:
        for rank in (1, 2, 3, 4):
            try:
                resolved = spec_fn((2,) * rank)
            except Exception:
                continue
            for part in resolved:
                if part is None:
                    continue
                for ax in (part if isinstance(part, tuple) else (part,)):
                    axes.add(ax)
    return frozenset(axes)


def _match(path: str, rules: Sequence[Rule]):
    for pattern, spec_fn in rules:
        if re.match(pattern, path):
            return spec_fn
    return None


def partition_spec(path: str, shape: Tuple[int, ...], mesh,
                   rules: Sequence[Rule]) -> P:
    """The first matching rule's spec over the torch ``shape`` of flax
    leaf ``path``, a dim that does not divide its axis (or an axis the
    mesh lacks) degrading to replicated."""
    spec_fn = _match(path, rules)
    if spec_fn is None:
        return P()
    order = flax_dim_order(path, len(shape))
    flax_shape = tuple(shape[order[d]] for d in range(len(shape)))
    axes: List[Optional[str]] = [None] * len(shape)
    for d, ax in enumerate(spec_fn(flax_shape)):
        axes[order[d]] = ax
    sizes = {n: axis_size(mesh, n) for n in axis_names(mesh)}
    for i, ax in enumerate(axes):
        if ax is not None and (ax not in sizes or shape[i] % sizes[ax]):
            logger.debug("tp: %s dim %d (%d) not divisible by axis %r — "
                         "replicating", path, i, shape[i], ax)
            axes[i] = None
    return P(*axes)


def _param_path(module: nn.Module, name: str) -> str:
    return "params/" + flax_key(module, name)


def spec_tree(tree: Any, mesh, rules: Optional[Sequence[Rule]] = None,
              module: Optional[nn.Module] = None) -> Dict[str, P]:
    """``{name: PartitionSpec}`` for every parameter of a module (or of
    ``module`` for every key of a ``state_dict`` ``tree``); buffers and
    rule misses resolve to replicated."""
    rules = default_tp_rules() if rules is None else rules
    if isinstance(tree, nn.Module):
        module = tree
        tree = {n: p for n, p in tree.named_parameters()}
    params = set(n for n, _ in module.named_parameters())
    out = {}
    for name, value in tree.items():
        full = full_shape(value)
        out[name] = (partition_spec(_param_path(module, name), tuple(full),
                                    mesh, rules)
                     if name in params and len(full) > 0 else P())
    return out


def _sharded_dim(spec: P) -> Optional[Tuple[int, str]]:
    dims = [(i, ax) for i, ax in enumerate(spec) if ax is not None]
    if len(dims) > 1:
        raise NotImplementedError(f"a tensor sharded over several dims "
                                  f"({spec}) is not supported")
    return dims[0] if dims else None


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """This rank's line along one mesh axis."""

    group: Any
    index: int
    size: int


def axis_ctx(mesh, name: str) -> AxisCtx:
    return AxisCtx(axis_group(mesh, name), axis_index(mesh, name),
                   axis_size(mesh, name))


@dataclasses.dataclass(frozen=True)
class Shard:
    """What :func:`shard_module` recorded of a parameter it cut: its spec,
    the sharded dim, the whole shape, this rank's line along the dim's
    axis, and whether a column layer's output stays sharded."""

    spec: P
    dim: int
    full: Tuple[int, ...]
    ctx: AxisCtx
    keep: bool


# parameter → its Shard (the parameter object is the key: placement keeps
# it and swaps its data for the shard)
_SHARDS: "WeakIdKeyDictionary" = WeakIdKeyDictionary()


def shard_of(t) -> Optional[Shard]:
    """The :class:`Shard` of a parameter :func:`shard_module` cut, else
    ``None``."""
    return _SHARDS.get(t) if isinstance(t, torch.Tensor) else None


def is_sharded(t) -> bool:
    """True for a parameter holding one rank's shard."""
    return shard_of(t) is not None


def spec_of(t) -> Optional[P]:
    """A sharded parameter's spec (``None`` for a whole tensor)."""
    sh = shard_of(t)
    return None if sh is None else sh.spec


def full_shape(t) -> Tuple[int, ...]:
    """A parameter's whole shape (its own for a whole tensor)."""
    sh = shard_of(t)
    return tuple(t.shape) if sh is None else sh.full


# ---------------------------------------------------------------------------
# Collectives and their autograd conjugates
# ---------------------------------------------------------------------------


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``, reduced in fp32 for
    half types."""
    y = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    y = y.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(t.dtype)


# (``all_gather_single`` is the newer torch's name for it)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def all_gather_dim(x: torch.Tensor, dim: int, ctx: AxisCtx) -> torch.Tensor:
    """The ranks' slices of ``dim`` concatenated in axis order, laid out
    contiguously (as the one-rank layer's output is, so the reductions
    downstream sum in the same order)."""
    if ctx.size == 1:
        return x
    dim = dim % x.dim()
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] * ctx.size,) + front.shape[1:])
    _all_gather(out, front, group=ctx.group)
    return out.movedim(0, dim).contiguous()


def slice_dim(x: torch.Tensor, dim: int, ctx: AxisCtx) -> torch.Tensor:
    """This rank's slice of ``dim``."""
    n = x.shape[dim] // ctx.size
    return x.narrow(dim, ctx.index * n, n)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' partial input
    gradients (a column layer's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward (a row layer's partial products); identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather forward along ``dim``; the backward slices."""

    @staticmethod
    def forward(ctx, x, dim, actx):
        ctx.dim, ctx.actx = dim, actx
        return all_gather_dim(x, dim, actx)

    @staticmethod
    def backward(ctx, g):
        return slice_dim(g, ctx.dim, ctx.actx).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    """Slice forward along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, actx):
        ctx.dim, ctx.actx = dim, actx
        return slice_dim(x, dim, actx).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.actx), None, None


def copy_to(x, actx: AxisCtx):
    return x if actx.group is None else _CopyTo.apply(x, actx.group)


def reduce_from(x, actx: AxisCtx):
    return x if actx.group is None else _ReduceFrom.apply(x, actx.group)


def gather_from(x, dim: int, actx: AxisCtx):
    return x if actx.group is None else _GatherFrom.apply(x, dim, actx)


def scatter_to(x, dim: int, actx: AxisCtx):
    return x if actx.group is None else _ScatterTo.apply(x, dim, actx)


def gathered(p: torch.Tensor) -> torch.Tensor:
    """A parameter whole: its shard all-gathered (gradient sliced back to
    the shard) when :func:`shard_module` sharded it, else itself."""
    sh = shard_of(p)
    return p if sh is None else gather_from(p, sh.dim, sh.ctx)


# ---------------------------------------------------------------------------
# Placement and the parallel layers
# ---------------------------------------------------------------------------


def _channel_dim(layer: nn.Module, x: torch.Tensor) -> int:
    return x.dim() - 1 if isinstance(layer, nn.Linear) else 1


def _apply(layer: nn.Module, x, w, b):
    if isinstance(layer, nn.Linear):
        return F.linear(x, w, b)
    if hasattr(layer, "pad_input"):         # core.layers' SAME padding
        x = layer.pad_input(x)
    return layer._conv_forward(x, w, b)


class _ColumnParallel:
    """A ``Linear``/``Conv`` whose output features are sharded."""

    def forward(self, x):
        sh = shard_of(self.weight)
        x = copy_to(x, sh.ctx)
        b = self.bias
        if b is not None and not is_sharded(b):
            b = scatter_to(b, 0, sh.ctx)
        y = _apply(self, x, self.weight, b)
        return y if sh.keep else gather_from(y, _channel_dim(self, y),
                                             sh.ctx)


class _RowParallel:
    """A ``Linear``/``Conv`` whose contraction is sharded."""

    def forward(self, x):
        sh = shard_of(self.weight)
        cdim = _channel_dim(self, x)
        full_in, local_in = sh.full[1], self.weight.shape[1]
        if x.shape[cdim] == full_in and full_in != local_in:
            x = scatter_to(x, cdim, sh.ctx)
        elif x.shape[cdim] != local_in:
            raise ValueError(f"row layer: input has {x.shape[cdim]} "
                             f"channels, the weight contracts {full_in} "
                             f"({local_in} a rank)")
        y = reduce_from(_apply(self, x, self.weight, None), sh.ctx)
        if self.bias is not None:
            shape = [1] * y.dim()
            shape[cdim] = -1
            y = y + self.bias.view(shape)
        return y


class _ChannelShardedNorm:
    """``NormalizeScale`` after a column layer whose channels stay sharded
    (SSD's conv4_3 under ``ssd_tp_rules``): the norm sums every rank's
    squares, each rank scales its own channels, and the sum's gradient is
    summed back too, since each rank's outputs use it."""

    def forward(self, x):
        if x.shape[1] == self.cmul.weight.shape[0]:
            return super().forward(x)
        if self.norm.p != 2.0 or self.norm.dim != 1:
            raise NotImplementedError("a channel-sharded NormalizeScale "
                                      "needs p=2 over dim 1")
        actx = self.model_axis
        sq = spmd.all_reduce_sum(torch.sum(x * x, dim=1, keepdim=True),
                                 actx.group)
        w = scatter_to(self.cmul.weight, 0, actx)
        return x / (torch.sqrt(sq) + self.norm.eps) * w.view(1, -1, 1, 1)


class _ShardedEmbed:
    """A ``DedupEmbed`` whose table is sharded.  Row-sharded: the ids its
    shard owns are looked up there, the others give zero rows, and the
    ranks' rows are summed over the axis (each id has one owner, so the
    sum is the whole table's lookup; the gradient lands on the owning
    shard).  Feature-sharded: the table is taken whole."""

    def forward(self, ids):
        sh = shard_of(self.embedding)
        if sh.dim != 0:
            return sharded_embedding_lookup(gathered(self.embedding), ids,
                                            mode=self.lookup)
        lo, n = shard_range(self.embedding)
        ids = torch.as_tensor(ids, device=self.embedding.device).long()
        mine = (ids >= lo) & (ids < lo + n)
        local = torch.where(mine, ids - lo, torch.zeros_like(ids))
        rows = sharded_embedding_lookup(self.embedding, local,
                                        mode=self.lookup)
        rows = rows * mine[..., None].to(rows.dtype)
        return reduce_from(rows, sh.ctx)


_PARALLEL: Dict[Tuple[type, type], type] = {}


def _make_parallel(m: nn.Module, mixin: type) -> None:
    """Swap ``m``'s class for its subclass with ``mixin``'s forward (its
    parameters, names and state dict unchanged)."""
    base = type(m)
    if issubclass(base, mixin):
        return
    key = (base, mixin)
    if key not in _PARALLEL:
        _PARALLEL[key] = type(f"{base.__name__}{mixin.__name__}",
                              (mixin, base), {})
    m.__class__ = _PARALLEL[key]


_LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d)


def shard_module(module: nn.Module, mesh,
                 rules: Optional[Sequence[Rule]] = None) -> Dict[str, P]:
    """Keep this rank's shard of every parameter ``rules`` shard on
    ``mesh`` (in place: the parameter's data becomes the shard, its
    :class:`Shard` recorded, and ``utils.spmd.whole`` told to gather it),
    turn each ``Linear``/``Conv`` that owns a sharded weight into its
    column or row layer and each ``DedupEmbed`` with a sharded table into
    its sharded lookup, and give ``NormalizeScale`` layers their model
    axis.  Parameters already sharded keep theirs (placing twice is a
    no-op).  Returns ``{name: spec}``."""
    rules = default_tp_rules() if rules is None else rules
    specs = spec_tree(module, mesh, rules)
    for name, p in module.named_parameters():
        if is_sharded(p):
            continue
        sd = _sharded_dim(specs[name])
        if sd is None:
            continue
        dim, ax = sd
        actx = axis_ctx(mesh, ax)
        full = tuple(p.shape)
        with torch.no_grad():
            p.data = slice_dim(p.data, dim, actx).contiguous().clone()
        keep = getattr(_match(_param_path(module, name), rules),
                       "keep_sharded", False)
        _SHARDS[p] = Shard(specs[name], dim, full, actx, keep)
        spmd.set_whole(p, gathered)
    for m in module.modules():
        if isinstance(m, _LAYERS) and is_sharded(m.weight):
            _make_parallel(m, {0: _ColumnParallel, 1: _RowParallel}[
                shard_of(m.weight).dim])
        elif isinstance(m, DedupEmbed) and is_sharded(m.embedding):
            _make_parallel(m, _ShardedEmbed)
        elif (isinstance(m, NormalizeScale)
              and axis_size(mesh, MODEL_AXIS) > 1):
            m.model_axis = axis_ctx(mesh, MODEL_AXIS)
            _make_parallel(m, _ChannelShardedNorm)
    return specs


def shard_tree(tree: Any, mesh, rules: Optional[Sequence[Rule]] = None,
               module: Optional[nn.Module] = None) -> Any:
    """A module: :func:`shard_module`, returned.  A ``{name: tensor}``
    tree of whole tensors (a ``state_dict`` of ``module``): each tensor's
    shard on this rank."""
    if isinstance(tree, nn.Module):
        shard_module(tree, mesh, rules)
        return tree
    specs = spec_tree(tree, mesh, rules, module=module)
    return {k: shard_tensor(v, specs[k], mesh) for k, v in tree.items()}


def shard_tensor(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    sd = _sharded_dim(spec)
    if sd is None:
        return x
    return slice_dim(x, sd[0], axis_ctx(mesh, sd[1])).contiguous().clone()


def gather_tensor(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole tensor from each rank's shard (every rank of the axis
    calls it)."""
    sd = _sharded_dim(spec)
    if sd is None:
        return x
    with torch.no_grad():
        return all_gather_dim(x.detach(), sd[0], axis_ctx(mesh, sd[1]))


def sharded_param_count(tree: Any) -> int:
    """Parameters whose recorded spec splits them over more than one
    rank (a module, or an iterable of tensors)."""
    tensors = tree.parameters() if isinstance(tree, nn.Module) else tree
    return sum(1 for t in tensors
               if is_sharded(t) and shard_of(t).ctx.size > 1)


# ---------------------------------------------------------------------------
# Row-sharded tables' sparse gradients
# ---------------------------------------------------------------------------


def shard_range(table: torch.Tensor) -> Optional[Tuple[int, int]]:
    """``(first id, rows)`` a row-sharded table's shard holds on this
    rank, or ``None`` for a table that is not row-sharded."""
    sh = shard_of(table)
    if sh is None or sh.dim != 0:
        return None
    n = table.shape[0]
    return sh.ctx.index * n, n


def owned_rows(grad: SparseRows, table: torch.Tensor) -> SparseRows:
    """The rows of a whole-table ``SparseRows`` gradient that this rank's
    shard of ``table`` owns, with shard-local ids, compacted and padded
    to the same static size (``grad`` itself for a whole table)."""
    rng = shard_range(table)
    if rng is None:
        return grad
    lo, n = rng
    size = grad.ids.shape[0]
    valid = torch.arange(size, device=grad.ids.device) < grad.count
    keep = valid & (grad.ids >= lo) & (grad.ids < lo + n)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    count = keep.sum().to(torch.int32)
    head = torch.arange(size, device=grad.ids.device) < count
    ids = torch.where(head, grad.ids[order] - lo,
                      torch.zeros_like(grad.ids))
    rows = grad.rows[order] * head[:, None].to(grad.rows.dtype)
    return SparseRows(ids=ids, rows=rows, count=count)
