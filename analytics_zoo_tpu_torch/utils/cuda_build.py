"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` for ``sm_90a``.  The hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so a second
call in the same checkout reuses the library and an edited source or
header rebuilds.  :func:`build_kernels` starts one
``nvcc`` per missing source, all at once, and waits for all of them.

Nothing is downloaded; a missing ``nvcc`` or a failed compile raises.

:func:`kernel_op` marks the four kernels' entry points, where the port
chooses between a kernel and its plain version, so that a recorded
program (``analysis/program.py``) holds each call as one op on either
device, as a jaxpr holds each ``pallas_call`` as one equation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contraction into fused multiply-adds: the kernels repeat the
    # reference's float arithmetic op by op, rounding after each
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNEL_SOURCES = ("nms_sweep", "detection_output", "persistent_rnn",
                  "persistent_rnn_bwd")
# the toolkit's nvJPEG codec (``data/native.py``), no kernel of the port
CODEC_SOURCES = ("nvjpeg_codec",)


def _cuda_lib_dir() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "lib64")


def link_flags(name: str) -> tuple:
    """Libraries a source links beyond the CUDA runtime: nvJPEG, found
    at run time through an rpath to the toolkit's ``lib64``."""
    if name == "nvjpeg_codec":
        return ("-lnvjpeg", "-Xlinker", f"-rpath={_cuda_lib_dir()}")
    return ()

_loaded: Dict[str, ctypes.CDLL] = {}

#: the program recorder of an audit in progress (``analysis/program.py``
#: sets it for one recorded run), else ``None``
RECORDER = None


def kernel_op(name: str):
    """Decorate a kernel's entry point: while an audit records, the call
    is one op named ``name`` with its tensors' dtypes and devices, and
    the ops inside it (the plain version's, on the CPU) are not recorded:
    on the card the kernel stands in their place.  The call itself, its
    kernel and its result are unchanged; with no audit recording the
    cost is one module-level check."""
    def mark(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if RECORDER is None:
                return fn(*args, **kwargs)
            return RECORDER.kernel(name, fn, args, kwargs)
        return entry
    return mark


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of analytics_zoo_tpu_torch cannot be built")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    flags = NVCC_FLAGS + link_flags(name)
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_kernels(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, in parallel.
    Returns name → library path; the compiler's report (registers,
    shared memory, spills from ``-Xptxas -v``) is kept beside each
    library as ``.log``."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu"),
               *link_flags(name)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)       # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_function(name: str, symbol: str, argtypes: Sequence):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its ``argtypes``
    set (pointers and the stream as ``c_void_p``: without argtypes ctypes
    would pass a Python int as a 32-bit C int and cut the pointer).
    Every entry returns the ``cudaError_t`` of its launches."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_kernels([name])[name]))
        lib.az_error_string.argtypes = [ctypes.c_int]
        lib.az_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, code: int, what: str) -> None:
    """Raise if a launch was refused (too many threads, too much shared
    memory): such a launch never runs, and a later synchronize does not
    report it."""
    if code != 0:
        msg = _loaded[name].az_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
