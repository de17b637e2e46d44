"""Engine: process and topology initialisation (counterpart of
``utils/engine.py``).

The reference configures one JAX controller over every device of a host
(``jax.distributed`` across hosts).  The port runs PyTorch's
multi-controller model instead: one process per rank, each driving one
device, joined by ``torch.distributed``.  :func:`init` starts the
process group from an :class:`EngineConfig` or the ``torchrun`` variables
(``COORDINATOR_ADDRESS`` or ``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``); the rank's device is
``cuda:LOCAL_RANK`` on a card and the CPU when the caller asks for it.
The backend is ``nccl`` on a card and ``gloo`` on the CPU; ranks that
share one card name ``gloo`` explicitly (NCCL refuses two ranks of one
communicator on one device, with its own error, which nothing here
catches).  Without a coordinator and at world size 1, :func:`init` starts
a one-rank group on a free ``localhost`` port.

:func:`spawn` starts ``world`` such processes on this host, each calling
one target function after :func:`init`, and collects their results: the
launcher of the port's multi-rank tests and of ``chip_smoke.py``'s
multi-rank phases.  Every wait has a deadline; on expiry, or when a rank
fails, every child is killed and the call raises.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import logging
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")

_device: Optional[torch.device] = None
# the directory holding the package, for the children's import path
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class EngineConfig:
    """``coordinator_address`` is ``host:port``; ``num_processes``,
    ``process_id`` and ``local_rank`` default to ``WORLD_SIZE``, ``RANK``
    and ``LOCAL_RANK``.  ``backend`` defaults to ``nccl`` on a card and
    ``gloo`` on the CPU; ``device="cpu"`` asks for the CPU."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    backend: Optional[str] = None
    local_rank: Optional[int] = None
    device: Optional[str] = None


def free_port() -> int:
    """A free TCP port on ``localhost`` (bound to port 0 and released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _env_int(value: Optional[int], name: str, default: int) -> int:
    return int(value if value is not None else os.environ.get(name, default))


def init(config: Optional[EngineConfig] = None) -> None:
    """Start the process group once and bind this rank to its device (a
    group the caller started is joined as it is)."""
    global _device
    if _device is not None and dist.is_initialized():
        return
    config = config or EngineConfig()
    env = os.environ
    coord = config.coordinator_address or env.get("COORDINATOR_ADDRESS")
    if coord is None and env.get("MASTER_ADDR"):
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = _env_int(config.num_processes, "WORLD_SIZE", 1)
    rank = _env_int(config.process_id, "RANK", 0)
    local_rank = _env_int(config.local_rank, "LOCAL_RANK", 0)
    dev = resolve_device(config.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        _device = dev
        return
    if coord is None:
        if world != 1:
            raise ValueError(f"a world of {world} ranks needs a coordinator "
                             "address (COORDINATOR_ADDRESS or MASTER_ADDR/"
                             "MASTER_PORT)")
        coord = f"127.0.0.1:{free_port()}"
    backend = config.backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            rank=rank, world_size=world)
    _device = dev
    logger.info("torch.distributed initialised: rank %d/%d on %s (%s)",
                rank, world, dev, backend)


def device() -> torch.device:
    """This rank's device (the default policy before :func:`init`)."""
    return _device if _device is not None else resolve_device(None)


def node_number() -> int:
    """Participating processes (reference ``Engine.nodeNumber``): one
    process per rank."""
    return dist.get_world_size() if dist.is_initialized() else 1


def core_number() -> int:
    """Local accelerator devices (per-host 'cores')."""
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() \
        else 1


def device_count() -> int:
    """Devices of the whole job: one a rank."""
    return node_number()


def local_batch(global_batch: int) -> int:
    """This process's share of a global batch."""
    n = node_number()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} hosts")
    return global_batch // n


def shutdown() -> None:
    """Tear the process group down (a rank's last call)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


# ---------------------------------------------------------------------------
# Local launcher
# ---------------------------------------------------------------------------


def _load_target(target: str):
    """``"package.module:function"`` or ``"path/to/file.py:function"``."""
    where, fn = target.rsplit(":", 1)
    if where.endswith(".py"):
        path = os.path.abspath(where)
        sys.path.insert(0, os.path.dirname(path))
        name = os.path.splitext(os.path.basename(path))[0]
        mod = sys.modules.get(name)
        if mod is None or getattr(mod, "__file__", None) != path:
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, fn)


def spawn(target: str, world: int, kwargs: Optional[Dict[str, Any]] = None,
          *, timeout: float = 300.0, device: Optional[str] = None,
          backend: Optional[str] = None, local_ranks: Optional[List[int]]
          = None, env: Optional[Dict[str, str]] = None) -> List[Any]:
    """Run ``target(**kwargs)`` in ``world`` fresh processes joined in one
    process group on a free ``localhost`` port, and return each rank's
    result (pickled back through a file), in rank order.

    ``device``/``backend`` go to each rank's :func:`init`;
    ``local_ranks`` sets each rank's ``LOCAL_RANK`` (all 0 to share one
    card).  A rank that exits non-zero, or a group still running after
    ``timeout`` seconds, kills every child and raises ``RuntimeError``
    with the ranks' output."""
    port = free_port()
    local_ranks = local_ranks or list(range(world))
    tmp = tempfile.mkdtemp(prefix="az_spawn_")
    args_path = os.path.join(tmp, "kwargs.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(kwargs or {}, f)
    procs, logs = [], []
    for r in range(world):
        child_env = dict(os.environ, **(env or {}))
        child_env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                         RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(local_ranks[r]))
        child_env.pop("COORDINATOR_ADDRESS", None)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [_PACKAGE_ROOT] + [p for p in child_env.get(
                "PYTHONPATH", "").split(os.pathsep) if p])
        log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
        logs.append(log)
        cmd = [sys.executable, "-m", "analytics_zoo_tpu_torch.utils.engine",
               target, args_path, os.path.join(tmp, f"rank{r}.pkl"),
               device or "", backend or ""]
        procs.append(subprocess.Popen(cmd, env=child_env, stdout=log,
                                      stderr=subprocess.STDOUT))
    # az-allow: one-clock — the spawned ranks' deadline is on the host's real time: a virtual clock cannot time out real child processes
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            # az-allow: one-clock — the spawned ranks' deadline is on the host's real time: a virtual clock cannot time out real child processes
            if time.monotonic() > deadline:
                failed = f"the group did not finish within {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    try:
        if failed is not None:
            out = []
            for r, log in enumerate(logs):
                log.seek(0)
                out.append(f"--- rank {r} ---\n{log.read()[-6000:]}")
            raise RuntimeError(f"spawn({target}): {failed}\n"
                               + "\n".join(out))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _child_main(argv: List[str]) -> None:
    target, args_path, out_path, dev, be = argv
    init(EngineConfig(device=dev or None, backend=be or None))
    with open(args_path, "rb") as f:
        kwargs = pickle.load(f)
    result = _load_target(target)(**kwargs)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    shutdown()


if __name__ == "__main__":
    # run through the package's module, whose globals the target sees
    from analytics_zoo_tpu_torch.utils import engine as _engine
    _engine._child_main(sys.argv[1:])
