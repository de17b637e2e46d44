"""Iterator transformers (counterpart of ``data/transformer.py``), host
code: the reference's ``Transformer[A, B]`` as ``Iterator[A] →
Iterator[B]``.  Subclasses override ``transform`` (one sample to one,
``None`` drops it) or ``apply_iter`` (the whole stream), compose with
``>>`` and ``clone()`` with independent random state.

Random decisions come from generators the stages hold.  The vision
stages hold :func:`sample_random` by default: ONE ``random.Random`` that
``data.parallel.seed_sample`` rewinds for every sample from the key the
reference's ``random.seed`` takes, so a seeded stream makes the
reference's decisions, draw for draw, where the reference draws from the
process-global ``random``.  Generators a stage owns (``RandomTransformer``,
``ShuffleBuffer``) are found by :func:`walk_rngs` and seeded as the
reference seeds them.
"""

from __future__ import annotations

import copy
import os
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence


class SampleRandom(random.Random):
    """The per-sample stream the vision stages draw from (see the module
    docstring).  There is one: a deepcopy or a pickle keeps it, and
    :func:`walk_rngs` skips it, so ``clone()`` and ``seed_rngs`` leave it
    to ``seed_sample``."""

    def __deepcopy__(self, memo):
        return self

    def __reduce__(self):
        return sample_random, ()


_SAMPLE_RANDOM = SampleRandom()


def sample_random() -> SampleRandom:
    """The process's per-sample ``random.Random`` (see the module
    docstring)."""
    return _SAMPLE_RANDOM


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

    def __call__(self, data: Iterable[Any]) -> Iterator[Any]:
        return self.apply_iter(iter(data))

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        """``a >> b``: feed a's output stream into b (BigDL ``->``)."""
        return ChainedTransformer(self, other)

    def clone(self) -> "Transformer":
        """Deep copy with INDEPENDENT randomness: per-worker clones must
        not replay each other's augmentation decisions.  deepcopy
        duplicates Mersenne state exactly, so every held RNG but the
        shared :func:`sample_random` is reseeded from the OS entropy
        pool."""
        c = copy.deepcopy(self)
        _reseed_rngs(c)
        return c


def walk_rngs(obj: Any, visit: Callable[[Any], None],
              _seen: Optional[set] = None) -> None:
    """Recursively find every RNG reachable from ``obj`` (attribute /
    dict / sequence walk, stable traversal order) and call ``visit`` on
    it.  Recognizes ``random.Random``, ``np.random.RandomState`` and
    ``np.random.Generator``; the shared :func:`sample_random` is skipped
    (``seed_sample`` seeds it).  The ONE discovery walk shared by
    ``clone()``'s entropy reseed below and the deterministic per-sample
    seeding in ``data.parallel``, in the reference's order."""
    import numpy as _np

    if _seen is None:
        _seen = set()
    if id(obj) in _seen:
        return
    _seen.add(id(obj))
    if isinstance(obj, SampleRandom):
        return
    if isinstance(obj, (random.Random, _np.random.RandomState,
                        _np.random.Generator)):
        visit(obj)
        return
    if isinstance(obj, dict):
        for v in obj.values():
            walk_rngs(v, visit, _seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            walk_rngs(v, visit, _seen)
    elif hasattr(obj, "__dict__"):
        walk_rngs(vars(obj), visit, _seen)


def _reseed_rngs(obj: Any) -> None:
    import numpy as _np

    def visit(rng):
        if isinstance(rng, random.Random):
            rng.seed(int.from_bytes(os.urandom(8), "little"))
        elif isinstance(rng, _np.random.RandomState):
            rng.seed(int.from_bytes(os.urandom(4), "little"))
        else:   # np.random.Generator — same bit-generator type (a
            # Philox state assigned to a PCG64 raises)
            rng.bit_generator.state = type(rng.bit_generator)(
                int.from_bytes(os.urandom(8), "little")).state

    walk_rngs(obj, visit)


class ChainedTransformer(Transformer):
    def __init__(self, *stages: Transformer):
        flat = []
        for s in stages:
            if isinstance(s, ChainedTransformer):
                flat.extend(s.stages)
            else:
                flat.append(s)
        self.stages: Sequence[Transformer] = flat

    def apply_iter(self, it: Iterator[Any]) -> Iterator[Any]:
        for stage in self.stages:
            it = stage.apply_iter(it)
        return it

    def transform(self, sample: Any) -> Any:
        """Per-sample composition, so a chain can be wrapped by
        RandomTransformer (e.g. ``Random(Expand >> RoiExpand, 0.5)`` in the
        SSD train chain).  Only valid when every stage is 1→1."""
        for stage in self.stages:
            sample = stage.transform(sample)
        return sample


class Pipeline(ChainedTransformer):
    """List-style composition (the Python API's ``Pipeline([...])``)."""

    def __init__(self, stages: Sequence[Transformer]):
        super().__init__(*stages)


class FnTransformer(Transformer):
    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def transform(self, sample):
        return self.fn(sample)


class ParallelTransformer(Transformer):
    """Run a 1→1 transformer over a thread pool: each pool thread lazily
    ``clone()``s the inner transformer so its own RNGs and scratch stay
    thread-private (the shared :func:`sample_random` stream is shared, as
    the reference's global ``random`` is, so the decisions are not
    seeded).  Output order is preserved (a bounded sliding window of
    futures)."""

    def __init__(self, inner: Transformer, workers: int = 8,
                 max_pending: Optional[int] = None):
        self.inner = inner
        self.workers = max(1, workers)
        self.max_pending = max_pending or 2 * self.workers

    def apply_iter(self, it: Iterator[Any]) -> Iterator[Any]:
        if self.workers == 1:
            yield from self.inner.apply_iter(it)
            return
        local = threading.local()

        def run(sample):
            t = getattr(local, "t", None)
            if t is None:
                t = local.t = self.inner.clone()
            return t.transform(sample)

        with ThreadPoolExecutor(self.workers) as ex:
            pending: deque = deque()
            for sample in it:
                pending.append(ex.submit(run, sample))
                if len(pending) >= self.max_pending:
                    out = pending.popleft().result()
                    if out is not None:
                        yield out
            while pending:
                out = pending.popleft().result()
                if out is not None:
                    yield out


class RandomTransformer(Transformer):
    """Apply the wrapped transformer with probability ``prob`` (e.g.
    ``Random(Expand >> RoiExpand, 0.5)`` in the SSD train chain), drawn
    from its own ``rng``."""

    def __init__(self, inner: Transformer, prob: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        self.prob = prob
        self.rng = rng or random.Random()

    def transform(self, sample):
        if self.rng.random() < self.prob:
            return self.inner.transform(sample)
        return sample


class ShuffleBuffer(Transformer):
    """Streaming record-level shuffle with a bounded ``buffer_size``
    window: fill the buffer, then for every incoming sample emit a
    uniformly-drawn buffered one and replace it; combine with
    ``shuffle_files=True`` on the record source so the window isn't
    limited to one shard's ordering."""

    def __init__(self, buffer_size: int = 1024,
                 rng: Optional[random.Random] = None):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self.buffer_size = buffer_size
        self.rng = rng or random.Random()

    def transform(self, sample: Any) -> Any:
        raise TypeError(
            "ShuffleBuffer is a stream (many-to-many) transformer; it "
            "cannot run per-sample inside ParallelTransformer or a "
            "per-sample chain — attach it with DataSet.shuffle()/"
            ".transform() directly")

    def apply_iter(self, it: Iterator[Any]) -> Iterator[Any]:
        buf: list = []
        for sample in it:
            if len(buf) < self.buffer_size:
                buf.append(sample)
                continue
            j = self.rng.randrange(self.buffer_size)
            buf[j], sample = sample, buf[j]
            yield sample
        self.rng.shuffle(buf)
        yield from buf
