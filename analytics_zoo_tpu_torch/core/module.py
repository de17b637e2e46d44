"""Containers and the ``Model`` wrapper (counterpart of ``core/module.py``).

The reference's BigDL-style combinators — ``Sequential``, ``ConcatTable``,
``ParallelTable``, ``JoinTable``, ``SelectTable``, ``FlattenTable``,
``CAddTable``, ``Lambda`` and ``Identity`` — as ``nn.Module``s.  A
container passes a keyword argument (``train=``, ``generator=``) only to
the children whose ``forward`` names it (:func:`accepted_kwargs`), so
mode flags reach Dropout and BatchNorm through mixed stacks.

:class:`Model` is the object-style wrapper of the reference (``build``,
``forward``, ``save``/``load``, ``load_weights``, ``summary``): an
``nn.Module`` holding the network as ``module``, on ``device`` (the GPU
unless the caller asks for the CPU).  ``build(seed, *example_inputs)``
materialises lazy layers with one forward on the examples, then draws
every parameter from a ``torch.Generator`` seeded with ``seed``, on the
CPU, so the same seed gives the same weights on any device.  In training
mode ``forward`` passes ``train=True`` and a dropout generator (seeded
with the build's seed, one a device) to a network that names them.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.core.layers import (Linear, SeededGenerators,
                                                 SpatialConvolution, _xavier_,
                                                 lecun_normal_)
from analytics_zoo_tpu_torch.utils.device import resolve_device

Module = nn.Module


class Lambda(nn.Module):
    """Wrap a pure function as a module (no parameters)."""

    def __init__(self, fn: Callable[..., Any]):
        super().__init__()
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


class Identity(nn.Module):
    def forward(self, x):
        return x


def accepted_kwargs(module: nn.Module, kwargs: dict) -> dict:
    """Subset of ``kwargs`` that ``module.forward`` accepts by name (all
    of them when it takes ``**kwargs``)."""
    if not kwargs:
        return kwargs
    sig = inspect.signature(type(module).forward)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return kwargs
    return {k: v for k, v in kwargs.items() if k in sig.parameters}


def _apply_child(layer: nn.Module, x, **kwargs):
    """Apply a child, forwarding only the keyword arguments it names, so a
    real ``TypeError`` inside the child is not masked."""
    return layer(x, **accepted_kwargs(layer, kwargs))


class Sequential(nn.Module):
    """Children applied in order (BigDL ``Sequential().add(...)``, built
    from a list)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, **kwargs):
        for layer in self.layers:
            x = _apply_child(layer, x, **kwargs)
        return x


class ConcatTable(nn.Module):
    """Every child on the same input; a tuple of their outputs."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, **kwargs):
        return tuple(_apply_child(layer, x, **kwargs) for layer in self.layers)


class ParallelTable(nn.Module):
    """The i-th child on the i-th element of the input tuple."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, xs, **kwargs):
        return tuple(_apply_child(layer, x, **kwargs)
                     for layer, x in zip(self.layers, xs))


class JoinTable(nn.Module):
    """Concatenate a tuple of tensors along ``axis`` (the batch is axis 0,
    as in the reference)."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, xs):
        return torch.cat(list(xs), dim=self.axis)


class SelectTable(nn.Module):
    def __init__(self, index: int = 0):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[self.index]


class FlattenTable(nn.Module):
    """Nested tuples and lists → one flat tuple, depth first."""

    def forward(self, xs):
        flat: List[Any] = []

        def rec(t):
            if isinstance(t, (tuple, list)):
                for u in t:
                    rec(u)
            else:
                flat.append(t)

        rec(xs)
        return tuple(flat)


class CAddTable(nn.Module):
    """Elementwise sum of a tuple of tensors (BigDL ``CAddTable``)."""

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


_DEFAULT_INIT = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def _takes_generator(fn) -> bool:
    try:
        return "generator" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw ``module``'s parameters from ``generator`` (a CPU generator;
    the module is on the CPU): a module whose ``reset_parameters`` takes
    a ``generator`` draws its own, ``core.layers``' ``Linear`` and
    convolutions get the reference's Xavier-uniform kernels and zero
    biases, a stock ``nn.Linear`` or convolution flax's defaults
    (LeCun-normal kernel, zero bias); anything else is walked into."""
    reset = getattr(module, "reset_parameters", None)
    if reset is not None and _takes_generator(reset):
        reset(generator=generator)
        return
    if isinstance(module, (Linear, SpatialConvolution)):
        _xavier_(module, generator)          # BigDL layers: Xavier-uniform
        return
    if isinstance(module, _DEFAULT_INIT):
        lecun_normal_(module.weight, module.weight[0].numel(), generator)
        if module.bias is not None:
            module.bias.zero_()
        return
    for child in module.children():
        init_parameters(child, generator)


def _shapes(out) -> Any:
    if isinstance(out, torch.Tensor):
        return list(out.shape)
    if isinstance(out, (tuple, list)):
        return [_shapes(o) for o in out]
    if isinstance(out, dict):
        return {k: _shapes(v) for k, v in out.items()}
    return type(out).__name__


class Model(nn.Module):
    """The network (``module``) with the reference's object-style surface.

    ``build(seed, *example_inputs)`` materialises and seeds the weights;
    ``forward`` runs the network on the model's device (numpy inputs are
    moved there), with ``train=True`` and a dropout generator in training
    mode (``train()``; ``evaluate()`` switches back); ``save``/``load``
    write and read the network's ``state_dict``; ``load_weights`` copies
    a ``state_dict``-shaped mapping (e.g. from ``utils.convert``) in."""

    def __init__(self, module: nn.Module, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.generators = SeededGenerators(0)
        self.eval()

    # -- lifecycle ---------------------------------------------------------
    def build(self, seed: int, *example_inputs, **kwargs) -> "Model":
        """One forward on ``example_inputs`` on the CPU (lazy layers take
        their shapes), then every parameter drawn from a generator seeded
        with ``seed``; the network goes back to the model's device and the
        dropout generators restart from ``seed``."""
        self.module.to("cpu")
        with torch.no_grad():
            self.module(*_to(example_inputs, torch.device("cpu")),
                        **accepted_kwargs(self.module, kwargs))
        init_parameters(self.module, torch.Generator().manual_seed(seed))
        self.module.to(self.device)
        self.generators = SeededGenerators(seed)
        return self

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    def parameter_count(self) -> int:
        """Total trainable parameter count."""
        return sum(p.numel() for p in self.module.parameters()
                   if p.requires_grad)

    def evaluate(self) -> "Model":
        """Inference mode (reference ``model.evaluate()``)."""
        return self.eval()

    def summary(self, *example_inputs, depth: Optional[int] = None,
                **kwargs) -> str:
        """The module tree as a table: each submodule (to ``depth``
        levels, all when None) with its type, output shapes and parameter
        count, from forward hooks on one forward of ``example_inputs``."""
        rows: Dict[int, tuple] = {}
        hooks = []
        for i, (name, m) in enumerate(self.module.named_modules()):
            level = 0 if not name else name.count(".") + 1
            if depth is not None and level > depth:
                continue

            def hook(mod, args, out, i=i, name=name):
                # a module called twice keeps its first call's row
                rows.setdefault(i, (name or "(model)", type(mod).__name__,
                                    _shapes(out),
                                    sum(p.numel() for p in mod.parameters())))
            hooks.append(m.register_forward_hook(hook))
        try:
            with torch.no_grad():
                self.module(*_to(example_inputs, self.device),
                            **accepted_kwargs(self.module, kwargs))
        finally:
            for h in hooks:
                h.remove()
        head = ("module", "type", "output shape", "params")
        cells = [head] + [(n, t, str(s), f"{p:,}")
                          for _, (n, t, s, p) in sorted(rows.items())]
        widths = [max(len(r[i]) for r in cells) for i in range(4)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths))
                 for r in cells]
        lines.insert(1, "-" * len(lines[0]))
        lines.append(f"total params: {self.parameter_count():,}")
        return "\n".join(lines)

    # -- forward -----------------------------------------------------------
    def forward(self, *inputs, generator: Optional[torch.Generator] = None):
        kwargs = {}
        if self.training:
            kwargs = accepted_kwargs(self.module, {
                "train": True,
                "generator": generator or self.generators(self.device)})
        return self.module(*_to(inputs, self.device), **kwargs)

    # -- serialization -----------------------------------------------------
    def save(self, path: str) -> None:
        torch.save(self.module.state_dict(), path)

    def load(self, path: str) -> "Model":
        self.module.load_state_dict(torch.load(path,
                                               map_location=self.device))
        return self

    def load_weights(self, state) -> "Model":
        """Copy a ``state_dict``-shaped mapping (tensors or arrays, every
        entry of the network present) into this model."""
        self.module.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()})
        return self


def _to(inputs, device: torch.device):
    """Numpy leaves as tensors on ``device``, tensors moved there."""
    from analytics_zoo_tpu_torch.parallel.train import to_device

    return to_device(tuple(inputs), device)
