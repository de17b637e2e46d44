"""Multiprocess host input pipeline (counterpart of ``data/parallel.py``):
the per-sample decode and augmentation chain fanned out to forked worker
processes, order-preserving and deterministically seeded.  Host code.

- The wrapped ``DataSet``'s stages split into leading stream stages
  (cheap, e.g. ``ShuffleBuffer``), the per-sample chain (decode,
  augmentation) and trailing stream stages (batchers).  Every worker
  iterates the raw source and the leading stages, applies the chain to
  its own sample groups only (group ``g`` to worker ``g % num_workers``),
  and the parent merges the groups in order and applies the trailing
  stages, so batches equal the serial path's.
- Groups travel through a per-worker shared-memory ring (``_Ring``):
  ndarray payloads out of band (pickle protocol 5), a slot published only
  once fully written, so a worker killed mid-write leaves nothing half
  written; a group larger than a slot spills to a file.
- Determinism: every sample's randomness is pinned by ``seed_sample``
  from ``(base_seed, epoch, sample index)``, the reference's keys, so the
  stream is byte-identical for any worker count, ``num_workers=0`` (the
  in-process serial path) included, and makes the JAX package's
  decisions.
- A worker that dies is respawned from the group it owes, at most
  ``max_respawns`` times an epoch, then :class:`PrefetchWorkerDied`.
- Forked workers run host code only: a worker asserts that CUDA is not
  initialised in it, and the loader refuses a chain that would decode
  with nvJPEG (a CUDA codec) in its workers.

``replay_batches`` re-materialises a checkpointed run's batches and
``elastic_resume_coordinates`` turns a checkpoint's sample offset into
loader terms.  ``make_input_pipeline`` gives each rank of a mesh its
slices of the global batches, uploaded ahead of the step.
"""

from __future__ import annotations

import hashlib
import logging
import multiprocessing as mp
import os
import pickle
import random
import shutil
import struct
import tempfile
import warnings
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.prefetch import PrefetchWorkerDied
from analytics_zoo_tpu_torch.data.transformer import (ChainedTransformer,
                                                      ParallelTransformer,
                                                      Transformer,
                                                      sample_random,
                                                      walk_rngs)

logger = logging.getLogger("analytics_zoo_tpu_torch")

_DEFAULT_SLOT_BYTES = 32 << 20
_POLL_S = 0.2
#: True in a forked worker process (``data.native`` refuses nvJPEG there)
_IN_WORKER = False


# ---------------------------------------------------------------------------
# Deterministic seeding
# ---------------------------------------------------------------------------


_SEEDABLE = (int, float, bool, str, bytes, type(None))


def stable_seed(*keys) -> int:
    """Stable 63-bit seed from scalar keys (process/run independent —
    Python's ``hash`` is salted, so it cannot be used here).  Keys are
    restricted to value-repr'd scalars (and tuples/lists of them): an
    arbitrary object's default repr embeds its ADDRESS, which would
    silently break the stability promise."""
    def check(k):
        if isinstance(k, (tuple, list)):
            for v in k:
                check(v)
        elif not isinstance(k, _SEEDABLE):
            raise TypeError(
                f"stable_seed keys must be int/float/bool/str/bytes/"
                f"None (or tuples of them), got {type(k).__name__} — "
                "an object repr would make the seed address-dependent")

    check(keys)
    h = hashlib.blake2s(repr(keys).encode())
    return struct.unpack("<q", h.digest()[:8])[0] & 0x7FFFFFFFFFFFFFFF


def seed_rngs(obj: Any, seed: int) -> None:
    """Deterministically seed every ``random.Random`` /
    ``np.random.RandomState`` / ``np.random.Generator`` reachable from
    ``obj`` (the shared ``transformer.walk_rngs`` discovery walk, so
    this and ``clone()``'s entropy reseed can never drift)."""
    count = [0]

    def visit(rng):
        s = stable_seed(seed, count[0])
        count[0] += 1
        if isinstance(rng, random.Random):
            rng.seed(s)
        elif isinstance(rng, np.random.RandomState):
            rng.seed(s & 0xFFFFFFFF)
        else:   # np.random.Generator — rebuild with the Generator's OWN
            # bit-generator type (a Philox state assigned to a PCG64
            # raises ValueError)
            rng.bit_generator.state = type(rng.bit_generator)(s).state

    walk_rngs(obj, visit)


def _rng_signature(rng: Any) -> str:
    """Value-based fingerprint of an RNG's CURRENT state (stable across
    processes — no addresses).  Folding a leading stage's construction-
    time signature into its per-epoch seeding key preserves the user's
    own seed choice (e.g. ``DataSet.shuffle(seed=...)``): two loaders
    built with different shuffle seeds keep producing different
    streams, while the reseed still pins determinism per epoch."""
    if isinstance(rng, random.Random):
        return repr(rng.getstate())
    if isinstance(rng, np.random.RandomState):
        kind, keys, pos, has_g, g = rng.get_state()
        return f"{kind}:{keys.tobytes().hex()}:{pos}:{has_g}:{g}"
    return repr(rng.bit_generator.state)        # np.random.Generator


def stream_stage_keys(leading: Sequence[Transformer]) -> List[str]:
    """One seeding key per leading stream stage, capturing the stage
    index and its RNGs' construction-time state signatures."""
    keys = []
    for i, stage in enumerate(leading):
        sigs: List[str] = []
        walk_rngs(stage, lambda r: sigs.append(_rng_signature(r)))
        keys.append(f"{i}:{':'.join(sigs)}")
    return keys


#: Process-local numpy Generator for per-sample transform randomness:
#: ``seed_sample`` rewinds it from ``(base_seed, epoch, sample_index)``
#: in whichever process runs the chain, as it rewinds
#: ``transformer.sample_random()``.
_SAMPLE_RNG = np.random.Generator(np.random.PCG64(0))


def sample_rng() -> np.random.Generator:
    """The per-sample-seeded local Generator for transform chains."""
    return _SAMPLE_RNG


def seed_sample(chain: Optional[Sequence[Transformer]], base_seed: int,
                epoch: int, index: int) -> None:
    """Pin ALL randomness for one sample's trip through the chain.

    The vision stages draw from ``transformer.sample_random()`` (and the
    samplers derive their numpy Generators from it), numpy consumers
    from :func:`sample_rng`, and chain-held RNGs are reseeded by
    ``seed_rngs`` — all from ``(base_seed, epoch, sample_index)``.  The
    first is seeded with the value the reference passes to
    ``random.seed``, so its draws are the reference's draws.  No global
    RNG is touched."""
    s = stable_seed("sample", base_seed, epoch, index)
    sample_random().seed(s)
    _SAMPLE_RNG.bit_generator.state = np.random.PCG64(s).state
    if chain:
        seed_rngs(chain, stable_seed("chain", base_seed, epoch, index))


# ---------------------------------------------------------------------------
# Stage classification
# ---------------------------------------------------------------------------


def _is_per_sample(stage: Transformer) -> bool:
    """True when ``stage`` is a 1->1 transformer (safe to run per sample
    inside a worker): it overrides ``transform`` and keeps the base
    streaming ``apply_iter`` (chains of such stages count too)."""
    if isinstance(stage, ParallelTransformer):
        return _is_per_sample(stage.inner)
    if isinstance(stage, ChainedTransformer):
        return all(_is_per_sample(s) for s in stage.stages)
    cls = type(stage)
    return (cls.transform is not Transformer.transform
            and cls.apply_iter is Transformer.apply_iter)


def _flatten_per_sample(stage: Transformer) -> List[Transformer]:
    """Unwrap a per-sample stage into its atomic 1->1 transformers:
    ``ParallelTransformer`` wrappers dissolve (the process pool replaces
    the thread pool) and chains flatten — at EVERY nesting level, so a
    wrapper nested inside a chain can never survive into the worker
    chain where its base-class identity ``transform`` would silently
    skip the wrapped work."""
    if isinstance(stage, ParallelTransformer):
        return _flatten_per_sample(stage.inner)
    if isinstance(stage, ChainedTransformer):
        out: List[Transformer] = []
        for s in stage.stages:
            out.extend(_flatten_per_sample(s))
        return out
    return [stage]


def split_stages(stages: Sequence[Transformer]
                 ) -> Tuple[List[Transformer], List[Transformer],
                            List[Transformer]]:
    """(leading stream stages, per-sample chain stages, trailing stages).

    ``ParallelTransformer`` wrappers are unwrapped — the process pool
    replaces the thread pool.  Everything from the first per-sample
    stage up to the next stream stage becomes the worker chain; the
    remainder (batchers etc.) runs in the parent."""
    leading: List[Transformer] = []
    chain: List[Transformer] = []
    trailing: List[Transformer] = []
    for stage in stages:
        if isinstance(stage, ParallelTransformer):
            stage = stage.inner
        if trailing:
            trailing.append(stage)
        elif _is_per_sample(stage):
            chain.extend(_flatten_per_sample(stage))
        elif chain:
            trailing.append(stage)
        else:
            leading.append(stage)
    return leading, chain, trailing


def _apply_chain(chain: Sequence[Transformer], sample: Any) -> Any:
    """Per-sample chain application with the streaming drop semantics:
    a ``None`` from any stage drops the sample (base ``apply_iter``)."""
    for stage in chain:
        sample = stage.transform(sample)
        if sample is None:
            return None
    return sample


# ---------------------------------------------------------------------------
# Shared-memory ring (headers + payload; crash-atomic, no pipes)
# ---------------------------------------------------------------------------

_KIND_GRP = 0
_KIND_END = 1
_KIND_ERR = 2
_KIND_SPILL = 3
# u32 kind | u64 idx | u64 meta_len | u32 nbufs  (then nbufs u64 lens,
# meta bytes, payload bytes — all inside one slot)
_HDR = struct.Struct("<IQQI")


class _Ring:
    """Single-producer single-consumer shared-memory ring.

    ``slots`` fixed-size slots used strictly round-robin; ``free``
    counts writable slots (producer acquires before writing), ``items``
    counts published slots (released only after a slot is COMPLETELY
    written — the crash-atomicity invariant: a producer killed at any
    instant leaves either a fully-published slot or an invisible one,
    never a truncated message).  The consumer copies out, then releases
    ``free``.  No pipes anywhere, so a SIGKILLed producer cannot wedge
    the consumer in a blocking read."""

    def __init__(self, ctx, slots: int, slot_bytes: int, spill_dir: str):
        from multiprocessing import shared_memory

        self.slots = slots
        self.slot_bytes = slot_bytes
        self.spill_dir = spill_dir
        self.shm = shared_memory.SharedMemory(create=True,
                                              size=slots * slot_bytes)
        self.free = ctx.Semaphore(slots)
        self.items = ctx.Semaphore(0)
        self.seq = 0            # producer- and consumer-side slot cursor

    def close(self) -> None:
        try:
            self.shm.close()
            self.shm.unlink()
        except Exception:
            pass

    # -- producer side (worker process) -----------------------------------
    def _write_slot(self, kind: int, idx: int, meta: bytes,
                    lens: Sequence[int], payload: Sequence) -> None:
        base = (self.seq % self.slots) * self.slot_bytes
        buf = self.shm.buf
        _HDR.pack_into(buf, base, kind, idx, len(meta), len(lens))
        off = base + _HDR.size
        for n in lens:
            struct.pack_into("<Q", buf, off, n)
            off += 8
        buf[off:off + len(meta)] = meta
        off += len(meta)
        for m in payload:
            buf[off:off + len(m)] = m
            off += len(m)
        self.seq += 1

    def put(self, kind: int, idx: int, meta: bytes, lens: Sequence[int],
            payload: Sequence, stop_event) -> bool:
        """Publish one message; False when cancelled via ``stop_event``."""
        need = _HDR.size + 8 * len(lens) + len(meta) + sum(lens)
        if need > self.slot_bytes:
            raise ValueError(
                f"message needs {need} bytes > slot_bytes={self.slot_bytes}"
                " (spill should have caught this)")
        while not self.free.acquire(timeout=_POLL_S):
            if stop_event.is_set():
                return False
        self._write_slot(kind, idx, meta, lens, payload)
        self.items.release()          # publish — ONLY after a full write
        return True

    def put_group(self, group_idx: int, samples: List[Any],
                  stop_event) -> Tuple[bool, bool]:
        """Ship one group of transformed samples.  Returns (ok,
        spilled): ndarray payloads go out-of-band through the slot;
        oversize groups degrade to a spill file referenced from the
        slot (written and fsync'd BEFORE the slot publishes, so the
        crash-atomicity invariant holds for them too)."""
        raw: List[memoryview] = []

        def grab(b) -> bool:
            # a falsy return serializes OUT-of-band (we captured the
            # buffer); True keeps a non-contiguous buffer in-band
            try:
                raw.append(b.raw())
                return False
            except BufferError:
                return True

        meta = pickle.dumps(samples, protocol=5, buffer_callback=grab)
        lens = [len(m) for m in raw]
        need = _HDR.size + 8 * len(lens) + len(meta) + sum(lens)
        if need <= self.slot_bytes:
            return (self.put(_KIND_GRP, group_idx, meta, lens, raw,
                             stop_event), False)
        # spill file carries meta AND payload: a group whose IN-BAND
        # pickle alone exceeds the slot (e.g. raw JPEG bytes objects)
        # must degrade the same way as one with big ndarray buffers
        path = os.path.join(self.spill_dir,
                            f"spill-{os.getpid()}-{group_idx}.bin")
        with open(path, "wb") as f:
            f.write(meta)
            for m in raw:
                f.write(m)
            f.flush()
            os.fsync(f.fileno())
        blob = pickle.dumps((len(meta), lens, path))
        return (self.put(_KIND_SPILL, group_idx, blob, (), (),
                         stop_event), True)

    # -- consumer side (parent) --------------------------------------------
    def get(self, timeout: float):
        """One published message or None on timeout: (kind, idx, obj)
        where obj is the unpickled group for GRP/SPILL, the pickled
        payload bytes for ERR, and None for END."""
        if not self.items.acquire(timeout=timeout):
            return None
        base = (self.seq % self.slots) * self.slot_bytes
        buf = self.shm.buf
        kind, idx, meta_len, nbufs = _HDR.unpack_from(buf, base)
        off = base + _HDR.size
        lens = []
        for _ in range(nbufs):
            lens.append(struct.unpack_from("<Q", buf, off)[0])
            off += 8
        meta = bytes(buf[off:off + meta_len])
        off += meta_len
        if kind == _KIND_GRP:
            bufs = []
            for n in lens:
                bufs.append(bytearray(buf[off:off + n]))    # copy out
                off += n
            self.seq += 1
            self.free.release()
            return kind, idx, pickle.loads(meta, buffers=bufs)
        self.seq += 1
        self.free.release()
        if kind == _KIND_SPILL:
            meta_len, s_lens, path = pickle.loads(meta)
            with open(path, "rb") as f:
                # bytearray: reconstructed arrays must be WRITABLE like
                # the ring path's (immutable bytes would make in-place
                # mutation fail only on groups that happened to spill)
                data = bytearray(f.read())
            os.unlink(path)
            view = memoryview(data)
            bufs, off2 = [], meta_len
            for n in s_lens:
                bufs.append(view[off2:off2 + n])
                off2 += n
            return _KIND_SPILL, idx, pickle.loads(view[:meta_len],
                                                  buffers=bufs)
        if kind == _KIND_ERR:
            return kind, idx, meta
        return kind, idx, None


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def _advance_source_epochs(source_fn, n: int) -> None:
    """Fast-forward a DataSet source's per-epoch closure state by ``n``
    epochs.  Every DataSet constructor advances its epoch counter inside
    the generator body, so creating the generator and pulling ONE item
    is enough to step the state without reading the whole epoch."""
    for _ in range(n):
        it = source_fn()
        next(iter(it), None)


def _worker_main(worker_id: int, num_workers: int, epoch: int,
                 start_group: int, ring: _Ring, stop_event,
                 source_fn, leading: List[Transformer],
                 stream_keys: List[str],
                 chain: List[Transformer], group_size: int,
                 base_seed: int) -> None:
    """Producer body (runs in a forked child; must never touch CUDA).

    Iterates the full raw stream (cheap), transforms only the groups
    owned by this shard, and ships them through the ring.  All
    randomness is pinned: worker-level RNGs from ``(base_seed, epoch,
    shard)``, per-sample RNGs folded in from the global stream index."""
    try:
        global _IN_WORKER
        # the chain runs host code only: the codec refuses nvJPEG here
        # (``native._nv``) before any CUDA call, on top of the loader's
        # refusal at construction; torch itself refuses to initialise
        # CUDA in a child forked from a process that has
        _IN_WORKER = True
        # per-worker base PRNG: worker-local decisions (none on the hot
        # path today, but the contract is part of the API)
        random.seed(stable_seed("worker", base_seed, epoch, worker_id))
        for stage, key in zip(leading, stream_keys):
            seed_rngs(stage, stable_seed("stream", base_seed, epoch, key))
        it: Iterator[Any] = iter(source_fn())
        for stage in leading:
            it = stage.apply_iter(it)

        group: List[Any] = []
        g = 0
        idx = 0
        mine = (g % num_workers == worker_id) and g >= start_group

        warned = [False]

        def flush() -> bool:
            if mine:
                ok, spilled = ring.put_group(g, group, stop_event)
                if spilled and not warned[0]:
                    warned[0] = True
                    logger.warning(
                        "input worker %d: group %d exceeded slot_bytes; "
                        "spilling to disk (size the ring slots to the "
                        "batch — further spills not logged)", worker_id, g)
                return ok
            return True

        for sample in it:
            if stop_event.is_set():
                return
            if mine:
                seed_sample(chain, base_seed, epoch, idx)
                out = _apply_chain(chain, sample)
                if out is not None:
                    group.append(out)
            idx += 1
            if idx % group_size == 0:
                if not flush():
                    return
                group = []
                g += 1
                mine = ((g % num_workers == worker_id)
                        and g >= start_group)
        if idx % group_size:
            if not flush():
                return
            g += 1
        ring.put(_KIND_END, g, b"", (), (), stop_event)
    except BaseException as e:  # noqa: BLE001 - shipped to the parent
        import traceback

        tb = traceback.format_exc()
        try:
            payload = pickle.dumps((e, tb))
        except Exception:
            payload = pickle.dumps((None, tb))
        try:
            ring.put(_KIND_ERR, 0, payload, (), (), stop_event)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


class ParallelLoader:
    """Order-preserving multiprocess loader over a ``DataSet``.

    ``num_workers=0`` runs the SAME deterministically-seeded pipeline
    in-process (the serial reference the parallel stream is pinned
    byte-identical to); ``num_workers>0`` fans the per-sample chain out
    to forked worker processes with shared-memory rings.

    One live iterator at a time: each ``iter()`` call starts a new
    epoch (advancing the shuffle state exactly like serial epochs do)
    and owns the worker pool until exhausted or ``.close()``d.

    Note on shared RNGs: the vision/augment transforms draw from the
    process-global ``random`` (pre-existing design) and numpy consumers
    from the loader-local :func:`sample_rng` Generator, so pinning them
    means ``seed_sample`` reseeds both per sample in whichever process
    runs the chain (numpy's process-GLOBAL RNG is never touched —
    seeded-rng-only rule).  With ``num_workers>0`` that is a forked
    worker; with ``num_workers=0`` it is THIS process (the prefetch
    thread, when composed with ``device_prefetch``) — code that draws
    from those RNGs concurrently with a serial-mode epoch will see
    sample-pinned values, exactly as it already would next to a
    ``ParallelTransformer`` thread pool.
    """

    def __init__(self, dataset, num_workers: int = 0, *,
                 base_seed: int = 0, group_size: Optional[int] = None,
                 slots: int = 4, slot_bytes: int = _DEFAULT_SLOT_BYTES,
                 max_respawns: int = 2, start_epoch: int = 0):
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        if num_workers > 0 and not getattr(dataset, "_order_deterministic",
                                           True):
            # every worker replays the raw stream independently; a
            # nondeterministically-ordered source (native_threads>0
            # record reader) would give each worker a DIFFERENT order
            # and the group partition would silently duplicate/drop
            # samples — refuse instead of corrupting the stream
            raise ValueError(
                "ParallelLoader(num_workers>0) requires a source with "
                "reproducible iteration order; this dataset's source is "
                "marked nondeterministic (e.g. from_record_files with "
                "native_threads>0) — use native_threads=0 or "
                "num_workers=0")
        if num_workers > 0 and cuda_codec_stages(dataset._stages):
            raise ValueError(
                "ParallelLoader(num_workers>0): the chain decodes with "
                "nvJPEG, which needs CUDA in the calling process, and a "
                "worker forked from this process cannot use CUDA; use "
                "num_workers=0 on a CUDA device, or decode with libjpeg "
                "(device='cpu')")
        self.dataset = dataset
        self.num_workers = num_workers
        self.base_seed = base_seed
        self.slots = max(2, slots)
        self.slot_bytes = slot_bytes
        self.max_respawns = max_respawns
        self._epoch = start_epoch
        if start_epoch:
            # resume contract (mid-epoch checkpoint restart): the caller
            # hands a FRESHLY-constructed dataset plus the checkpointed
            # epoch, and the loader owns BOTH halves of the coordinate —
            # the per-epoch seeding keys (stable_seed folds the epoch
            # index) AND the source's own per-epoch closure state
            # (e.g. from_arrays' reshuffle counter).  Without this, a resumed
            # process replays epoch 0's sample ORDER under epoch N's
            # seeds — a silently different stream.
            _advance_source_epochs(self.dataset._source_fn, start_epoch)
        self.leading, self.chain, self.trailing = split_stages(
            dataset._stages)
        # construction-time RNG signatures: the per-epoch reseed of
        # leading stream stages folds in the user's own seed choice
        self._stream_keys = stream_stage_keys(self.leading)
        if group_size is None:
            group_size = next((s.batch_size for s in self.trailing
                               if hasattr(s, "batch_size")), 32)
        self.group_size = max(1, int(group_size))
        # observability (tests + chaos drills read these)
        self.respawns = 0
        self.spills = 0
        #: epoch index of the most recently STARTED epoch (None before
        #: the first): with base_seed and a batch index, the determinism
        #: contract pins a batch
        self.last_epoch: Optional[int] = None
        self._procs: List[mp.Process] = []
        if num_workers > 0 and not hasattr(os, "fork"):  # pragma: no cover
            warnings.warn("platform lacks fork(); ParallelLoader falls "
                          "back to the serial path")
            self.num_workers = 0

    # -- public surface ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.dataset)

    def worker_pids(self) -> List[int]:
        """Live worker PIDs of the current epoch (chaos drills)."""
        return [p.pid for p in self._procs if p.is_alive()]

    def __iter__(self) -> Iterator[Any]:
        if any(p.is_alive() for p in self._procs):
            # enforce the one-live-iterator contract: a second pool
            # would fork from the previous epoch's UN-advanced source
            # state (silent stream corruption) and clobber the first
            # pool's cleanup tracking
            raise RuntimeError(
                "previous epoch's worker pool is still live — exhaust "
                "or close() the prior iterator before starting a new "
                "epoch (ParallelLoader supports one live iterator)")
        epoch = self._epoch
        self._epoch += 1
        self.last_epoch = epoch
        if self.num_workers == 0:
            return self._serial_epoch(epoch)
        return self._apply_trailing(self._merged_samples(epoch))

    # -- serial reference path --------------------------------------------
    def _serial_epoch(self, epoch: int) -> Iterator[Any]:
        for stage, key in zip(self.leading, self._stream_keys):
            seed_rngs(stage, stable_seed("stream", self.base_seed, epoch,
                                         key))
        it: Iterator[Any] = iter(self.dataset._source_fn())
        for stage in self.leading:
            it = stage.apply_iter(it)

        def samples():
            for idx, sample in enumerate(it):
                seed_sample(self.chain, self.base_seed, epoch, idx)
                out = _apply_chain(self.chain, sample)
                if out is not None:
                    yield out

        return self._apply_trailing(samples())

    def _apply_trailing(self, it: Iterator[Any]) -> Iterator[Any]:
        for stage in self.trailing:
            it = stage.apply_iter(it)
        return it

    # -- parallel path ----------------------------------------------------
    def _spawn(self, ctx, worker_id: int, epoch: int, start_group: int,
               stop_event, spill_dir: str) -> Tuple[_Ring, mp.Process]:
        ring = _Ring(ctx, self.slots, self.slot_bytes, spill_dir)
        proc = ctx.Process(
            target=_worker_main,
            args=(worker_id, self.num_workers, epoch, start_group, ring,
                  stop_event, self.dataset._source_fn, self.leading,
                  self._stream_keys, self.chain, self.group_size,
                  self.base_seed),
            daemon=True)
        with warnings.catch_warnings():
            # CPython warns (a DeprecationWarning since 3.12) that fork
            # of a multithreaded process may deadlock; workers run data
            # and transform code only, and touch no CUDA
            for category in (RuntimeWarning, DeprecationWarning):
                warnings.filterwarnings("ignore", message=".*fork.*",
                                        category=category)
            proc.start()
        return ring, proc

    def _merged_samples(self, epoch: int) -> Iterator[Any]:
        ctx = mp.get_context("fork")
        stop_event = ctx.Event()
        W = self.num_workers
        spill_dir = tempfile.mkdtemp(prefix="azt-loader-")
        # forked children inherit the parent's source state verbatim, so
        # the parent must NOT consume the source itself this epoch; it
        # advances its copy once in the finally below, which keeps
        # serial epochs and parallel epochs interchangeable.
        rings: List[_Ring] = []
        procs: List[mp.Process] = []
        respawns_left = self.max_respawns
        for w in range(W):
            ring, proc = self._spawn(ctx, w, epoch, 0, stop_event,
                                     spill_dir)
            rings.append(ring)
            procs.append(proc)
        self._procs = procs
        try:
            g = 0
            total_groups: Optional[int] = None
            while total_groups is None or g < total_groups:
                w = g % W
                kind, payload = self._next_message(
                    ctx, w, g, epoch, rings, procs, stop_event, spill_dir,
                    respawns_left)
                if kind == "respawned":
                    respawns_left -= 1
                    continue
                if kind == "end":
                    total_groups = payload
                    continue   # re-check the loop condition (g == total)
                for sample in payload:
                    yield sample
                g += 1
        finally:
            # pool cleanup FIRST (a failing source advance must never
            # leave workers spinning on live rings)...
            stop_event.set()
            for proc in procs:
                proc.join(timeout=1.0)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=5.0)
            for ring in rings:
                ring.close()
            shutil.rmtree(spill_dir, ignore_errors=True)
            self._procs = []
            # ...then advance the parent's copy of the source state by
            # one epoch, so serial and parallel epochs stay
            # interchangeable.  Workers (and respawns) always fork from
            # the UN-advanced state — respawns happen only inside the
            # loop, never after this point.
            _advance_source_epochs(self.dataset._source_fn, 1)

    def _next_message(self, ctx, w: int, g: int, epoch: int,
                      rings: List[_Ring], procs: List[mp.Process],
                      stop_event, spill_dir: str, respawns_left: int):
        """Wait for worker ``w``'s next ring message, handling death.

        Returns ("grp", samples) / ("end", total) / ("respawned", None).
        A dead worker with an empty ring is respawned from the group it
        still owes — deterministic seeding makes the respawn recompute
        the identical stream — until the respawn budget is exhausted,
        then PrefetchWorkerDied (retryable) escalates."""
        while True:
            msg = rings[w].get(timeout=_POLL_S)
            if msg is None:
                if procs[w].is_alive():
                    continue
                # dead — drain the publish-vs-death race window before
                # declaring the ring empty
                msg = rings[w].get(timeout=0.0)
                if msg is None:
                    if respawns_left <= 0:
                        raise PrefetchWorkerDied(
                            f"input worker {w} (pid {procs[w].pid}) died "
                            f"at group {g} with the respawn budget "
                            f"exhausted (max_respawns="
                            f"{self.max_respawns}) — input pipeline is "
                            "gone; restart the attempt")
                    logger.warning(
                        "input worker %d died (exitcode %s); respawning "
                        "from group %d (%d respawns left)", w,
                        procs[w].exitcode, g, respawns_left - 1)
                    rings[w].close()
                    ring, proc = self._spawn(ctx, w, epoch, g, stop_event,
                                             spill_dir)
                    rings[w] = ring
                    procs[w] = proc
                    self._procs = procs
                    self.respawns += 1
                    return "respawned", None
            kind, idx, obj = msg
            if kind == _KIND_ERR:
                try:
                    exc, tb = pickle.loads(obj)
                except Exception:
                    exc, tb = None, "<worker exception unpicklable — " \
                        "traceback lost in transit>"
                if exc is not None:
                    # chain the worker-side traceback (the parent-side
                    # raise alone would point only at this frame)
                    raise exc from RuntimeError(
                        f"input worker {w} traceback:\n{tb}")
                # unknown exception type: re-raise as a BARE RuntimeError
                # (NOT retryable PrefetchWorkerDied — a deterministic
                # programming error must propagate, never be retried)
                raise RuntimeError(
                    f"input worker {w} raised an unpicklable exception:"
                    f"\n{tb}")
            if kind == _KIND_SPILL:
                self.spills += 1
                kind = _KIND_GRP
            if kind == _KIND_END:
                if idx > g:  # pragma: no cover - protocol bug
                    raise PrefetchWorkerDied(
                        f"worker {w} ended at group {idx} while group "
                        f"{g} was still owed")
                return "end", idx
            if idx != g:  # pragma: no cover - protocol bug
                raise PrefetchWorkerDied(
                    f"worker {w} sent group {idx}, expected {g}")
            return "grp", obj


# ---------------------------------------------------------------------------
# Deterministic replay and resume coordinates
# ---------------------------------------------------------------------------


def replay_batches(dataset, epoch: int, batch_indices: Sequence[int],
                   base_seed: int = 0, batch_transform=None):
    """Re-materialise exact batches of ``epoch`` under the determinism
    contract (the forensics and re-seek hook).

    ``dataset`` must be freshly constructed (its source at its epoch-0
    state): a :class:`ParallelLoader` (its own ``base_seed`` and grouping
    win) or a bare ``DataSet`` (run on the serial path with
    ``base_seed``).  The source is fast-forwarded ``epoch`` epochs, the
    per-epoch and per-sample RNGs are pinned as the live run pinned them,
    for any worker count, and the requested 0-based batch indices of that
    epoch come back as ``{index: batch}``.  ``batch_transform(batch,
    index)`` post-processes each one."""
    if isinstance(dataset, ParallelLoader):
        loader = ParallelLoader(dataset.dataset, 0,
                                base_seed=dataset.base_seed,
                                group_size=dataset.group_size)
    else:
        loader = ParallelLoader(dataset, 0, base_seed=base_seed)
    want = sorted({int(i) for i in batch_indices})
    if not want:
        return {}
    _advance_source_epochs(loader.dataset._source_fn, epoch)
    out = {}
    for i, batch in enumerate(loader._serial_epoch(epoch)):
        if i in want:
            out[i] = (batch_transform(batch, i) if batch_transform
                      else batch)
        if i >= want[-1]:
            break
    missing = [i for i in want if i not in out]
    if missing:
        raise ValueError(
            f"epoch {epoch} ended before batch index(es) {missing} — "
            "wrong epoch coordinate, or the dataset was not freshly "
            "constructed (its source state already advanced)")
    return out


def elastic_resume_coordinates(epoch: int, samples_into_epoch: int,
                               global_batch: int):
    """A checkpoint's sample coordinate in loader terms under a (possibly
    different) batch geometry: ``(start_epoch, skip_batches)``.  The
    deterministic stream is defined over the merged sample sequence, so
    only the batch size matters; an offset that does not land on a batch
    boundary of the new stream raises ``ValueError``."""
    if epoch < 0 or samples_into_epoch < 0 or global_batch < 1:
        raise ValueError(
            f"elastic_resume_coordinates: invalid coordinate (epoch="
            f"{epoch}, samples={samples_into_epoch}, batch={global_batch})")
    if samples_into_epoch % global_batch:
        raise ValueError(
            f"elastic resume: sample offset {samples_into_epoch} is not "
            f"a multiple of the new global batch {global_batch} — the "
            f"checkpoint boundary does not land on a batch boundary of "
            f"the resumed stream")
    return int(epoch), samples_into_epoch // global_batch


class _RankSlices:
    """Each global batch of ``loader`` cut to this rank's rows
    (``parallel.mesh.shard_batch``); ``close`` reaches the loader's
    epoch."""

    def __init__(self, loader, mesh, microbatches: int):
        self.loader, self.mesh = loader, mesh
        self.microbatches = microbatches

    def __iter__(self):
        from analytics_zoo_tpu_torch.parallel.mesh import shard_batch

        it = iter(self.loader)
        try:
            for batch in it:
                yield shard_batch(batch, self.mesh,
                                  microbatches=self.microbatches)
        finally:
            if hasattr(it, "close"):
                it.close()

    def __len__(self):
        return len(self.loader)


class InputPipeline:
    """The iterable :func:`make_input_pipeline` returns: each ``iter()``
    one epoch of this rank's slices of the global batches, on the rank's
    device, ``prefetch`` ahead on a card (pinned, side-stream uploads),
    as they come on the CPU.  ``yields_local_slices`` tells the
    ``Optimizer`` not to cut them again."""

    yields_local_slices = True

    def __init__(self, slices, device, prefetch: int):
        from analytics_zoo_tpu_torch.data.prefetch import PrefetchDataSet

        self.slices = slices
        self.device = device
        self._feed = (PrefetchDataSet(slices, device, size=prefetch)
                      if device.type == "cuda" and prefetch > 0 else slices)

    def __iter__(self):
        return iter(self._feed)

    def __len__(self):
        return len(self.slices)


def make_input_pipeline(dataset, mesh, num_workers: int = 0,
                        prefetch: int = 2, base_seed: int = 0,
                        loader: Optional["ParallelLoader"] = None,
                        device=None, microbatches: int = 1,
                        **loader_kw) -> InputPipeline:
    """The host-to-device input pipeline of one rank: the global batches
    of ``dataset`` through ``ParallelLoader`` (``num_workers`` forked
    workers, seeded by ``base_seed``; or ``loader``), each cut to this
    rank's rows over the mesh's ``data`` axis, uploaded by
    ``data.prefetch.device_prefetch`` ``prefetch`` batches ahead of the
    step on the rank's device (``utils.engine.device``, or ``device``).
    ``microbatches``: the step's ``grad_accum`` (a rank keeps its share of
    each microbatch).  Every rank builds the same pipeline over the same
    dataset."""
    from analytics_zoo_tpu_torch.utils import engine
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    if loader is None:
        loader = ParallelLoader(dataset, num_workers, base_seed=base_seed,
                                **loader_kw)
    return InputPipeline(_RankSlices(loader, mesh, microbatches),
                         engine.device() if device is None
                         else resolve_device(device), prefetch)


def cuda_codec_stages(stages) -> List[Any]:
    """The stages (searched through chains and wrappers) that decode or
    encode on the GPU: ``codec == "nvjpeg"``."""
    found: List[Any] = []
    seen: set = set()

    def walk(obj):
        if id(obj) in seen or isinstance(obj, (str, bytes, np.ndarray)):
            return
        seen.add(id(obj))
        if getattr(obj, "codec", None) == "nvjpeg":
            found.append(obj)
        if isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
        elif hasattr(obj, "__dict__"):
            walk(vars(obj))

    walk(list(stages))
    return found
