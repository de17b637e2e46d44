"""The native data path (counterpart of ``data/native.py``): the threaded
``.azr`` record reader and the JPEG codecs, bound with ctypes.

Two codecs, chosen by the device the pipeline runs on and never switched
at run time:

- ``"libjpeg"`` (``device="cpu"``): ``csrc/azrecord.cpp``, built with
  ``g++`` at first use into ``_build/libazrecord-<hash>.so`` and linked
  with libjpeg where ``jpeglib.h`` is on the include path.  Host code
  only, so forked loader workers may decode with it.
- ``"nvjpeg"`` (a CUDA device): the CUDA toolkit's nvJPEG through
  ``csrc/nvjpeg_codec.cu``, built by ``utils/cuda_build.py``.  It needs
  CUDA in the calling process, so a loader whose forked workers would
  decode refuses it (``data/parallel.py``).

A corrupt JPEG decodes to ``None`` (the feature is dropped with a
warning); a codec that will not build or load raises.  There is no cv2
route: the reference's fallback to ``cv2.imdecode`` when its library is
missing does not exist here.  EXIF orientation is applied after either
codec, as ``cv2.imdecode`` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR

CODECS = ("libjpeg", "nvjpeg")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_host_lib: Optional[ctypes.CDLL] = None
_nvjpeg = None


def has_libjpeg_header() -> bool:
    """Whether ``g++`` finds ``jpeglib.h`` (decides the library's build:
    with libjpeg, or the record reader alone)."""
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                           input="#include <jpeglib.h>\n", text=True,
                           capture_output=True)
    return probe.returncode == 0


def host_library_path(with_jpeg: bool) -> Path:
    src = CSRC_DIR / "azrecord.cpp"
    flags = CXX_FLAGS + (f"-DAZ_WITH_JPEG={int(with_jpeg)}",)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"libazrecord-{digest[:16]}.so"


def build_host_library() -> Path:
    """Compile ``csrc/azrecord.cpp`` with ``g++`` unless its library
    (hashed by source and flags) is already built; a failed compile
    raises."""
    with_jpeg = has_libjpeg_header()
    out = host_library_path(with_jpeg)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, f"-DAZ_WITH_JPEG={int(with_jpeg)}", "-o",
           str(tmp), str(CSRC_DIR / "azrecord.cpp"), "-lpthread"]
    if with_jpeg:
        cmd.append("-ljpeg")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"azrecord build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a reader never sees half a file
    return out


def _host() -> ctypes.CDLL:
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    lib = ctypes.CDLL(str(build_host_library()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.az_reader_open.restype = ctypes.c_void_p
    lib.az_reader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.az_reader_next.restype = ctypes.c_long
    lib.az_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p)]
    lib.az_buffer_free.argtypes = [u8p]
    lib.az_buffer_free.restype = None
    lib.az_reader_close.argtypes = [ctypes.c_void_p]
    lib.az_reader_close.restype = None
    lib.az_count_records.restype = ctypes.c_long
    lib.az_count_records.argtypes = [ctypes.c_char_p]
    lib.az_has_jpeg.restype = ctypes.c_int
    if lib.az_has_jpeg():
        lib.az_decode_jpeg.restype = ctypes.c_int
        lib.az_decode_jpeg.argtypes = [
            u8p, ctypes.c_long, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.az_encode_jpeg.restype = ctypes.c_int
        lib.az_encode_jpeg.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_long)]
    _host_lib = lib
    return lib


def _libjpeg() -> ctypes.CDLL:
    lib = _host()
    if not lib.az_has_jpeg():
        raise RuntimeError(
            "the libjpeg codec is not built: g++ finds no jpeglib.h on "
            "this machine; on a CUDA device the codec is nvJPEG "
            "(codec='nvjpeg')")
    return lib


class _NvJpeg:
    """The nvJPEG entry points of ``csrc/nvjpeg_codec.cu``."""

    def __init__(self):
        from analytics_zoo_tpu_torch.utils import cuda_build

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int)
        load = cuda_build.load_function
        self.init = load("nvjpeg_codec", "az_nvjpeg_init", [])
        self.info = load("nvjpeg_codec", "az_nvjpeg_info",
                         [u8p, ctypes.c_long, i32p, i32p])
        self.decode = load("nvjpeg_codec", "az_nvjpeg_decode",
                           [u8p, ctypes.c_long, u8p, ctypes.c_int,
                            ctypes.c_int])
        self.encode = load("nvjpeg_codec", "az_nvjpeg_encode",
                           [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(u8p),
                            ctypes.POINTER(ctypes.c_long)])
        self.free = cuda_build._loaded["nvjpeg_codec"].az_nvjpeg_free
        self.free.argtypes = [u8p]
        self.free.restype = None
        self.check(self.init(), "nvJPEG setup")

    @staticmethod
    def check(code: int, what: str) -> None:
        from analytics_zoo_tpu_torch.utils import cuda_build

        cuda_build.check_launch("nvjpeg_codec", code, what)


def _nv() -> _NvJpeg:
    global _nvjpeg
    import torch

    from analytics_zoo_tpu_torch.data import parallel

    if parallel._IN_WORKER:
        raise RuntimeError("a forked input worker must not touch CUDA: "
                           "the nvJPEG codec runs in the main process")
    if not torch.cuda.is_available():
        raise RuntimeError("the nvJPEG codec needs a CUDA device")
    if _nvjpeg is None:
        torch.cuda.init()
        _nvjpeg = _NvJpeg()
    return _nvjpeg


def codec_for(device) -> str:
    """The codec a pipeline on ``device`` decodes and encodes with."""
    import torch

    return "nvjpeg" if torch.device(device).type == "cuda" else "libjpeg"


def check_codec(codec: str) -> None:
    """Build and load ``codec`` now: a codec that cannot raises here,
    before any record is read."""
    if codec not in CODECS:
        raise ValueError(f"unknown JPEG codec {codec!r}; expected one of "
                         f"{CODECS}")
    if codec == "nvjpeg":
        _nv()
    else:
        _libjpeg()


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


class NativeRecordReader:
    """Threaded reader over sharded ``.azr`` files; yields payload bytes.
    Record order inside a file is kept per thread; across files it is
    nondeterministic with ``n_threads > 1`` (one thread for a fixed
    order)."""

    def __init__(self, paths: Sequence[str], n_threads: int = 4,
                 queue_capacity: int = 128):
        self._lib = _host()
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode("utf-8") for p in paths])
        self._handle = self._lib.az_reader_open(arr, len(paths), n_threads,
                                                queue_capacity)
        if not self._handle:
            raise ValueError("az_reader_open failed (no paths?)")

    def __iter__(self) -> Iterator[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = self._lib.az_reader_next(self._handle, ctypes.byref(out))
            if n < 0:
                return
            try:
                yield ctypes.string_at(out, n)
            finally:
                self._lib.az_buffer_free(out)

    def close(self) -> None:
        if self._handle:
            self._lib.az_reader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def count_records(path: str) -> int:
    return int(_host().az_count_records(path.encode("utf-8")))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def _exif_orientation(data: bytes) -> int:
    """EXIF Orientation tag (1..8; 1 = upright) from raw JPEG bytes."""
    try:
        if data[:2] != b"\xff\xd8":
            return 1
        i = 2
        while i + 4 <= len(data):
            if data[i] != 0xFF:
                return 1
            marker = data[i + 1]
            if marker == 0xD9 or marker == 0xDA:
                return 1
            size = int.from_bytes(data[i + 2:i + 4], "big")
            if marker == 0xE1 and data[i + 4:i + 10] == b"Exif\x00\x00":
                tiff = i + 10
                bo = "little" if data[tiff:tiff + 2] == b"II" else "big"
                ifd = tiff + int.from_bytes(data[tiff + 4:tiff + 8], bo)
                n = int.from_bytes(data[ifd:ifd + 2], bo)
                for k in range(n):
                    e = ifd + 2 + k * 12
                    if int.from_bytes(data[e:e + 2], bo) == 0x0112:
                        v = int.from_bytes(data[e + 8:e + 10], bo)
                        return v if 1 <= v <= 8 else 1
                return 1
            i += 2 + size
    except Exception:
        pass
    return 1


def _apply_orientation(arr: np.ndarray, o: int) -> np.ndarray:
    if o == 2:
        return arr[:, ::-1]
    if o == 3:
        return arr[::-1, ::-1]
    if o == 4:
        return arr[::-1]
    if o == 5:
        return np.transpose(arr, (1, 0, 2))
    if o == 6:
        return np.rot90(arr, 3)
    if o == 7:
        return np.transpose(arr, (1, 0, 2))[::-1, ::-1]
    if o == 8:
        return np.rot90(arr, 1)
    return arr


def _u8(buf) -> "ctypes.POINTER(ctypes.c_uint8)":
    return ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))


def _decode_libjpeg(data: bytes) -> Optional[np.ndarray]:
    lib = _libjpeg()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.az_decode_jpeg(buf, len(data), ctypes.byref(out), ctypes.byref(w),
                          ctypes.byref(h), ctypes.byref(c)) != 0:
        return None
    try:
        return np.ctypeslib.as_array(
            out, shape=(h.value, w.value, c.value)).copy()
    finally:
        lib.az_buffer_free(out)


def _decode_nvjpeg(data: bytes) -> Optional[np.ndarray]:
    nv = _nv()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = nv.info(buf, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc == 1:
        return None
    nv.check(rc, "nvJPEG image info")
    arr = np.empty((h.value, w.value, 3), np.uint8)
    rc = nv.decode(buf, len(data), _u8(arr.ctypes.data), w.value, h.value)
    if rc == 1:
        return None
    nv.check(rc, "nvJPEG decode")
    return arr


def decode_jpeg(data: bytes, codec: str = "libjpeg") -> Optional[np.ndarray]:
    """JPEG bytes → (H, W, 3) BGR uint8 with the EXIF orientation applied;
    ``None`` when the bytes do not decode.  A codec that cannot build or
    load raises."""
    arr = (_decode_nvjpeg(data) if codec == "nvjpeg"
           else _decode_libjpeg(data) if codec == "libjpeg" else None)
    if arr is None:
        if codec not in CODECS:
            raise ValueError(f"unknown JPEG codec {codec!r}")
        return None
    orientation = _exif_orientation(data)
    if orientation != 1:
        return np.ascontiguousarray(_apply_orientation(arr, orientation))
    return arr


def encode_jpeg(img: np.ndarray, quality: int = 92,
                codec: str = "libjpeg") -> bytes:
    """(H, W, 3) BGR uint8 → baseline JPEG bytes at ``quality`` (4:2:0),
    what ``cv2.imencode(".jpg")`` writes."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) BGR, got {img.shape}")
    h, w = img.shape[:2]
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_long()
    if codec == "nvjpeg":
        nv = _nv()
        nv.check(nv.encode(_u8(img.ctypes.data), w, h, int(quality),
                           ctypes.byref(out), ctypes.byref(n)),
                 "nvJPEG encode")
        free = nv.free
    elif codec == "libjpeg":
        lib = _libjpeg()
        if lib.az_encode_jpeg(_u8(img.ctypes.data), w, h, int(quality),
                              ctypes.byref(out), ctypes.byref(n)) != 0:
            raise RuntimeError("libjpeg encode failed")
        free = lib.az_buffer_free
    else:
        raise ValueError(f"unknown JPEG codec {codec!r}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        free(out)
