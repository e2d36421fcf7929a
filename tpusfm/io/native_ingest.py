"""ctypes bindings for the native C++ ingest library.

The reference decodes images in C++ inside an OpenMP loop
(sparseBuilder.cpp:679-752 via OpenMVG ReadImage); tpusfm's equivalent is
native/src/ingest.cpp — a worker-pool JPEG/PNG/PNM/BMP decoder behind a C
ABI.  This module loads it lazily and exposes batch loaders; tpusfm.io.images
falls back to numpy / PIL when the library is unavailable.

The library is built from the tracked sources only: a stamp beside it holds
the hash of native/src and native/build.sh, and a library whose stamp does
not match (or that has none, like one left from another checkout) is
rebuilt before it is loaded, or not loaded at all when the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_ROOT = Path(__file__).resolve().parent.parent.parent
_LIB_PATH = _ROOT / "native" / "lib" / "libtpusfm_ingest.so"
_BUILD_SH = _ROOT / "native" / "build.sh"
_STAMP = _LIB_PATH.with_name(_LIB_PATH.name + ".stamp")


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in [_BUILD_SH, *sorted((_ROOT / "native" / "src").glob("*"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _build_if_stale() -> bool:
    """Make the library match the tracked sources; False if it cannot."""
    if not _BUILD_SH.exists():
        return False
    want = _source_hash()
    if _LIB_PATH.exists() and _STAMP.exists() and _STAMP.read_text() == want:
        return True
    _STAMP.unlink(missing_ok=True)
    _LIB_PATH.unlink(missing_ok=True)
    # Build under a private name and rename: concurrent processes (test
    # workers) never load a half-written library.
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["sh", str(_BUILD_SH), str(tmp)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    stamp_tmp = _STAMP.with_name(f"{_STAMP.name}.{os.getpid()}.tmp")
    stamp_tmp.write_text(want)
    os.replace(stamp_tmp, _STAMP)
    return True


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not _build_if_stale():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.tsfm_image_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.tsfm_image_info.restype = ctypes.c_int
    lib.tsfm_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.tsfm_load_batch.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def image_info(path: str | Path):
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    if not lib.tsfm_image_info(str(path).encode(), ctypes.byref(w),
                               ctypes.byref(h), ctypes.byref(c)):
        return None
    return w.value, h.value, c.value


def load_batch(paths, width: int, height: int, gray: bool = True,
               rgb: bool = False, n_threads: int = 0):
    """Decode a uniform-size batch with the native worker pool.

    Returns (gray (N, H, W) float32 | None, rgb (N, H, W, 3) u8 | None,
    status (N,) bool) or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    n_threads = n_threads or (os.cpu_count() or 2)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    gray_arr = np.empty((n, height, width), np.float32) if gray else None
    rgb_arr = np.empty((n, height, width, 3), np.uint8) if rgb else None
    status = np.zeros(n, np.int32)
    lib.tsfm_load_batch(
        c_paths, n, width, height,
        gray_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if gray else None,
        rgb_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if rgb else None,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads,
    )
    return gray_arr, rgb_arr, status.astype(bool)


def exif_info(path: str | Path) -> dict | None:
    """Native EXIF metadata of a JPEG (focal mm, 35mm-equivalent focal,
    GPS lat/lon/alt, camera make/model) — the C++ counterpart of the
    reference's Exif_IO_EasyExif reads (sparseBuilder.cpp:389-465, getGPS
    .cpp:112).  Returns a dict with present keys only, or None when the
    library is unavailable or the file carries no EXIF."""
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_exif_bound", False):
        lib.tsfm_exif.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.tsfm_exif.restype = ctypes.c_int
        lib._exif_bound = True
    focal = ctypes.c_double()
    f35 = ctypes.c_double()
    lat = ctypes.c_double()
    lon = ctypes.c_double()
    alt = ctypes.c_double()
    make = ctypes.create_string_buffer(64)
    model = ctypes.create_string_buffer(64)
    has = lib.tsfm_exif(str(path).encode(), ctypes.byref(focal),
                        ctypes.byref(f35), ctypes.byref(lat),
                        ctypes.byref(lon), ctypes.byref(alt),
                        make, 64, model, 64)
    if has <= 0:
        return None
    out: dict = {}
    if has & 1:
        out["focal_mm"] = focal.value
    if has & 2:
        out["focal_35mm"] = f35.value
    if has & 4:
        out["gps"] = (lat.value, lon.value, alt.value)
    if has & 8:
        out["make"] = make.value.decode(errors="replace")
        out["model"] = model.value.decode(errors="replace")
    return out
