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

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
from analytics_zoo_tpu_torch.parallel import tensor as tensor_lib
from analytics_zoo_tpu_torch.parallel.mesh import PartitionSpec as P
from analytics_zoo_tpu_torch.resilience.errors import ElasticPlacementError


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
    overrides (declared; placing with them raises, item 12b.3)."""

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
    ``"megatron"`` paired column/row weight sharding
    (``tensor.ssd_tp_rules``); ``"spatial"`` (image height over
    ``model``) is ROADMAP.md Queue 1 item 12b.3."""
    if tp is None:
        return SpecSet(mesh)
    if tp == "spatial":
        raise NotImplementedError(
            "ssd tp='spatial' (image height over the model axis, with its "
            "halo exchanges) is not ported yet (ROADMAP.md Queue 1 item "
            "12b.3)")
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
