"""Declare-once partition specs: the one sharding substrate (counterpart
of ``parallel/specs.py``).

A pipeline declares a :class:`SpecSet` once — a mesh, the state rules of
``parallel/tensor.py`` and the batch specs — and everything that places
tensors consumes it: ``make_train_step``/``make_eval_step``, the
``Optimizer``, ``checkpoint.restore_elastic``.  Data and tensor
parallelism compose by changing the mesh's shape, not the pipeline.

The port runs one process per rank, so placement is local:
``place_state`` keeps each rank's shard of a parameter (the spec is
recorded on it: ``tensor.shard_module``) and broadcasts the replicated
ones from rank 0; ``place_batch`` keeps the rank's rows; ``gather``
assembles whole host tensors from the shards, byte-identical to what was
placed.

Registry::

    specs = pipeline_specs("ds2", mesh=mesh)          # declared once
    specs.place_state(model)
    step = make_train_step(model, crit, optim, specs=specs)
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
from analytics_zoo_tpu_torch.parallel.mesh import PartitionSpec as P
from analytics_zoo_tpu_torch.resilience.errors import ElasticPlacementError
from analytics_zoo_tpu_torch.utils import spmd


def _spec_axes(spec) -> set:
    axes = set()
    for part in spec:
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            axes.add(ax)
    return axes


def _leading_dim(tree) -> Optional[int]:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            d = _leading_dim(v)
            if d is not None:
                return d
        return None
    shape = getattr(tree, "shape", None)
    return int(shape[0]) if shape else None


@dataclasses.dataclass(frozen=True)
class SpecSet:
    """One pipeline's declared sharding: mesh, state rules (``None``:
    everything replicated, pure data parallelism) and per-key batch
    overrides (a dim past 0 over an axis: the image rows over ``model``,
    spatial partitioning)."""

    mesh: Any
    rules: Optional[Sequence] = None
    batch_overrides: Optional[Dict[str, P]] = None

    # -- spec trees -------------------------------------------------------
    def state_specs(self, state: Any, module: Optional[nn.Module] = None
                    ) -> Dict[str, P]:
        """``{name: PartitionSpec}`` for a module's parameters, or for a
        ``state_dict`` of ``module``."""
        if self.rules is None:
            names = (dict(state.named_parameters())
                     if isinstance(state, nn.Module) else state)
            return {k: P() for k in names}
        return tensor_lib.spec_tree(state, self.mesh, self.rules,
                                    module=module)

    def batch_specs(self, batch: Any) -> Any:
        """Dim 0 over ``data`` for every leaf, 0-d leaves replicated,
        ``batch_overrides`` per top-level key."""
        axis = mesh_lib.data_axis(self.mesh)

        def default(leaf):
            ndim = np.ndim(leaf) if not hasattr(leaf, "ndim") else leaf.ndim
            return P() if ndim == 0 else P(axis, *([None] * (ndim - 1)))

        if not (self.batch_overrides and isinstance(batch, dict)):
            return mesh_lib._tree_map(default, batch)
        return {k: (mesh_lib._tree_map(lambda _, k=k:
                                       self.batch_overrides[k], v)
                    if k in self.batch_overrides
                    else mesh_lib._tree_map(default, v))
                for k, v in batch.items()}

    @property
    def data_axis_size(self) -> int:
        """Width of the batch-carrying axis (replica count)."""
        return mesh_lib.data_width(self.mesh)

    def data_group(self):
        """The process group along ``data`` (``None`` at width 1)."""
        return mesh_lib.axis_group(self.mesh, mesh_lib.data_axis(self.mesh))

    @property
    def row_axis(self) -> Optional[str]:
        """The axis a batch override cuts a dim past 0 over (the image
        rows of spatial partitioning), or ``None``."""
        axes = {ax for spec in (self.batch_overrides or {}).values()
                for part in tuple(spec)[1:] if part is not None
                for ax in (part if isinstance(part, tuple) else (part,))}
        if len(axes) > 1:
            raise ValueError(f"batch overrides cut rows over {sorted(axes)}"
                             ": one axis at most")
        return next(iter(axes), None)

    def row_group(self):
        """The group the rows are cut over (``None``: no override, or a
        one-rank axis).  A replicated parameter's gradient is a sum of
        its ranks' rows' shares over it."""
        axis = self.row_axis
        return None if axis is None else mesh_lib.axis_group(self.mesh, axis)

    def row_scope(self):
        """``utils.spmd.row_shards`` over :meth:`row_group` (nothing
        without one): the scope a forward on placed rows runs in."""
        group = self.row_group()
        return (contextlib.nullcontext() if group is None
                else spmd.row_shards(group))

    def ragged_dispatch(self, annotated: Callable, plain: Callable
                        ) -> Callable:
        """``dispatch(*args)`` runs ``annotated`` when the first
        argument's leading dim divides the data width, else ``plain``: a
        ragged tail runs whole on every rank, as the reference's plain
        program does."""
        width = self.data_axis_size

        def dispatch(*args):
            d = _leading_dim(args[0])
            if d is not None and d % width == 0:
                return annotated(*args)
            return plain(*args)

        return dispatch

    def row_sharded(self, fn: Callable) -> Callable:
        """``fn(*args)`` run on this rank's rows of every batch-major
        argument (dim 0 over ``data``, and under a spatial declaration
        the image rows of its block, ``batch_overrides["input"]``; other
        arguments whole) in :meth:`row_scope`, its tensor outputs
        all-gathered back along dim 0 in rank order: a program's rows
        over the data ranks (a forward and its post-processing alike).
        A ragged batch runs whole on every rank
        (:meth:`ragged_dispatch`); with neither a data width nor a row
        axis, ``fn`` itself.  Every rank calls it with the same
        arguments; an exception in a rank's placement or ``fn`` fails
        the call on every rank (:func:`gather_rows_guarded`), so that no
        rank is left waiting in the gather."""
        if self.data_axis_size == 1 and self.row_group() is None:
            return fn
        ctx = tensor_lib.axis_ctx(self.mesh, mesh_lib.data_axis(self.mesh))

        def local(args):
            placed = self.place_batch({"input": args})["input"]
            with self.row_scope():
                return fn(*placed)

        def annotated(*args):
            if ctx.size == 1:
                return local(args)
            return gather_rows_guarded(lambda: local(args), ctx)

        return self.ragged_dispatch(annotated, fn)

    # -- elastic resize ---------------------------------------------------
    def declared_axes(self) -> frozenset:
        axes = set()
        for spec in (self.batch_overrides or {}).values():
            axes |= _spec_axes(spec)
        if self.rules:
            axes |= set(tensor_lib.rule_axes(self.rules))
        return frozenset(axes)

    def missing_axes(self) -> tuple:
        return tuple(sorted(self.declared_axes()
                            - set(mesh_lib.axis_names(self.mesh))))

    def replace_mesh(self, new_mesh) -> "SpecSet":
        """The same declaration on another mesh (a snapshot saved at
        width W restores at W′ through ``place_state`` under the result).
        Raises :class:`ElasticPlacementError` when ``new_mesh`` drops an
        axis the declaration resolves on the current mesh."""
        names = set(mesh_lib.axis_names(self.mesh))
        active = self.declared_axes() & names
        missing = tuple(sorted(active - set(mesh_lib.axis_names(new_mesh))))
        if missing:
            raise ElasticPlacementError(
                f"replace_mesh: new mesh axes "
                f"{tuple(mesh_lib.axis_names(new_mesh))} do not cover "
                f"declared axes {missing} that the current mesh "
                f"{tuple(mesh_lib.axis_names(self.mesh))} resolves — an "
                f"elastic re-placement must not silently drop active "
                f"sharding")
        return dataclasses.replace(self, mesh=new_mesh)

    def _require_override_axes(self, site: str) -> None:
        missing = tuple(sorted(
            {ax for spec in (self.batch_overrides or {}).values()
             for ax in _spec_axes(spec)}
            - set(mesh_lib.axis_names(self.mesh))))
        if missing:
            raise ElasticPlacementError(
                f"{site}: mesh axes {tuple(mesh_lib.axis_names(self.mesh))} "
                f"do not cover batch-override axes {missing} — the "
                f"declaration cannot be placed on this mesh")

    # -- placement --------------------------------------------------------
    def place_state(self, state: Any, module: Optional[nn.Module] = None
                    ) -> Any:
        """A module: its replicated tensors broadcast from rank 0 and its
        rule-matched parameters cut to this rank's shards (in place;
        returned).  A ``state_dict`` of ``module`` holding whole tensors:
        each cut to this rank's shard."""
        self._require_override_axes("place_state")
        if isinstance(state, nn.Module):
            mesh_lib.replicate(state, self.mesh)
            if self.rules is not None:
                tensor_lib.shard_module(state, self.mesh, self.rules)
            return state
        if self.rules is None:
            return state
        return tensor_lib.shard_tree(state, self.mesh, self.rules,
                                     module=module)

    def place_batch(self, batch: Any, microbatches: int = 1) -> Any:
        """This rank's rows of a host batch (dim 0 over ``data``; its
        share of each of ``microbatches`` equal microbatches)."""
        self._require_override_axes("place_batch")
        return mesh_lib.shard_batch(batch, self.mesh,
                                    overrides=self.batch_overrides,
                                    microbatches=microbatches)

    def gather(self, tree: Any, specs: Optional[Dict[str, P]] = None
               ) -> Any:
        """Whole host (numpy) copies: of a module's ``state_dict``, or of
        a ``{name: tensor}`` tree whose shards carry their spec (or whose
        specs ``specs`` gives), each shard assembled from every rank of
        its axis (a collective: every rank calls it)."""
        if isinstance(tree, nn.Module):
            tree = tree.state_dict(keep_vars=True)
        out = {}
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                spec = (specs or {}).get(k, tensor_lib.spec_of(v))
                if spec is not None:
                    v = tensor_lib.gather_tensor(v, spec, self.mesh)
                v = v.detach().cpu().numpy().copy()
            out[k] = v
        return out


def gather_rows_guarded(local: Callable[[], Any], ctx) -> Any:
    """``local()`` (a rank's rows through a program with no collective
    over ``ctx`` of its own), then its tensor outputs all-gathered along
    dim 0 over ``ctx`` (a ``tensor.AxisCtx``), in rank order.  The ranks
    first all-gather a header, whether ``local()`` returned and the
    bytes of its outputs: if one raised, every rank raises (that rank
    its own error), and no rank enters a gather that a peer will never
    join.  The outputs then travel as one gather of their bytes, which
    every rank cuts back into tensors of its own outputs' shapes."""
    from analytics_zoo_tpu_torch.utils import engine

    try:
        out, err = local(), None
    except Exception as e:          # noqa: BLE001 - re-raised below
        out, err = None, e
    ys: list = []
    if err is None:
        mesh_lib._tree_map(lambda y: ys.append(y) if _gathered(y) else y,
                           out)
    with torch.inference_mode():
        payload = (torch.cat([y.detach().reshape(-1).view(torch.uint8)
                              for y in ys]) if ys
                   else torch.empty(0, dtype=torch.uint8))
        # a gloo group gathers the header on the host: no device sync
        hdev = ("cpu" if torch.distributed.get_backend(ctx.group) == "gloo"
                else engine.device())
        header = torch.tensor([int(err is not None), payload.numel()],
                              dtype=torch.int64, device=hdev)
        headers = header.new_empty(ctx.size * 2)
        tensor_lib._all_gather(headers, header, group=ctx.group)
        failed, sizes = headers.view(-1, 2).T.tolist()
        if err is not None:
            raise err
        if any(failed):
            raise RuntimeError("sharded call: a peer rank failed its rows "
                               "of this batch")
        if len(set(sizes)) > 1:
            raise ValueError(f"sharded call: the ranks' outputs differ in "
                             f"size ({sizes} bytes)")
        whole = payload.new_empty(ctx.size * payload.numel())
        tensor_lib._all_gather(whole, payload, group=ctx.group)
        whole = whole.view(ctx.size, -1)
        at = [0]

        def cut(y):
            if not _gathered(y):
                return y
            n = y.numel() * y.element_size()
            part = whole[:, at[0]:at[0] + n].contiguous().view(y.dtype)
            at[0] += n
            return part.reshape((ctx.size * y.shape[0],) + y.shape[1:])

        return mesh_lib._tree_map(cut, out)


def _gathered(y) -> bool:
    return isinstance(y, torch.Tensor) and y.ndim > 0


# ---------------------------------------------------------------------------
# Pipeline registry
# ---------------------------------------------------------------------------

_PIPELINES: Dict[str, Callable[..., SpecSet]] = {}


def register_pipeline(name: str):
    """Register a ``builder(mesh, **opts) -> SpecSet`` under ``name``."""
    def deco(fn: Callable[..., SpecSet]):
        _PIPELINES[name] = fn
        return fn
    return deco


def registered_pipelines() -> Sequence[str]:
    return tuple(sorted(_PIPELINES))


def pipeline_specs(name: str, mesh=None, **opts: Any) -> SpecSet:
    """The declared :class:`SpecSet` of a registered pipeline on ``mesh``
    (default: a 1-D data mesh over every rank)."""
    if name not in _PIPELINES:
        raise KeyError(f"no specs registered for pipeline {name!r} "
                       f"(registered: {', '.join(registered_pipelines())})")
    return _PIPELINES[name](mesh or mesh_lib.create_mesh(), **opts)


@register_pipeline("ssd")
def _ssd_specs(mesh, tp: Optional[str] = None,
               resolution: int = 300) -> SpecSet:
    """SSD training and serving: ``tp=None`` data parallel,
    ``"spatial"`` the image height over ``model`` with the parameters
    replicated (``tensor.spatial_input_spec``; the forward fetches its
    halos, ``models.ssd.spatial_forward``), ``"megatron"`` paired
    column/row weight sharding (``tensor.ssd_tp_rules``)."""
    if tp is None:
        return SpecSet(mesh)
    if tp == "spatial":
        return SpecSet(mesh, batch_overrides={
            "input": tensor_lib.spatial_input_spec()})
    if tp == "megatron":
        return SpecSet(mesh,
                       rules=tensor_lib.ssd_tp_rules(resolution=resolution))
    raise ValueError(f"ssd tp mode {tp!r} (None | 'spatial' | 'megatron')")


@register_pipeline("frcnn")
def _frcnn_specs(mesh) -> SpecSet:
    """Faster-RCNN training: data parallel."""
    return SpecSet(mesh)


@register_pipeline("ds2")
def _ds2_specs(mesh, param_rules: Optional[Sequence] = None) -> SpecSet:
    """DeepSpeech2 CTC training: batches over ``data``, optional tensor
    parallel rules on a data × model mesh."""
    return SpecSet(mesh, rules=param_rules)


@register_pipeline("fraud")
def _fraud_specs(mesh) -> SpecSet:
    """The fraud MLP: data parallel."""
    return SpecSet(mesh)


@register_pipeline("rec")
def _rec_specs(mesh, shard_tables: bool = True) -> SpecSet:
    """NeuralCF / Wide&Deep: data-parallel batches, every ``embedding``
    table row-sharded over ``model`` when the mesh has that axis."""
    return SpecSet(mesh, rules=(tensor_lib.embedding_row_rules()
                                if shard_tables else None))


@register_pipeline("sentiment")
def _sentiment_specs(mesh, shard_tables: bool = True) -> SpecSet:
    """The sentiment heads: the table row-sharded as in ``rec``."""
    return SpecSet(mesh, rules=(tensor_lib.embedding_row_rules()
                                if shard_tables else None))
