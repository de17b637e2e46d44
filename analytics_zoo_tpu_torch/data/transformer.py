"""Iterator transformers (counterpart of ``data/transformer.py``): the
reference's ``Transformer[A, B]`` as ``Iterator[A] → Iterator[B]``.
Subclasses override ``transform`` (one sample to one) or ``apply_iter``
(the whole stream).  Host code."""

from __future__ import annotations

from typing import Any, Callable, Iterator


class Transformer:
    """Base: override ``transform(sample)`` or ``apply_iter(iterator)``;
    a ``transform`` that returns ``None`` drops the sample."""

    def transform(self, sample: Any) -> Any:
        return sample

    def apply_iter(self, it: Iterator[Any]) -> Iterator[Any]:
        for sample in it:
            out = self.transform(sample)
            if out is not None:
                yield out


class FnTransformer(Transformer):
    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def transform(self, sample):
        return self.fn(sample)
