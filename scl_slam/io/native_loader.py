"""ctypes bindings for the native C++ prefetching scan loader.

Builds ``libscl_native.so`` on first use (make, g++); falls back to the
pure-Python reader when a toolchain is unavailable. The loader reads
velodyne ``.bin`` files with a worker pool into fixed-capacity padded host
buffers — the static-shape contract the device pipeline expects — so disk
I/O overlaps with device compute.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libscl_native.so"))

_lib = None


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s"], cwd=os.path.abspath(_NATIVE_DIR), check=True,
            capture_output=True,
        )
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH) and not _build():
        return None
    lib = ctypes.CDLL(_SO_PATH)
    if not hasattr(lib, "sc_images_batch"):
        # stale .so from before the symbol existed: rebuild once, then
        # reload; give up (don't break the loader path) if still missing
        if not _build():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        if not hasattr(lib, "sc_images_batch"):
            return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.sc_images_batch.restype = None
    lib.sc_images_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def sc_images_batch(
    xyz: np.ndarray,
    mask: np.ndarray | None,
    num_rings: int,
    num_sectors: int,
    max_radius: float,
    lidar_height: float,
    n_threads: int = 4,
) -> np.ndarray | None:
    """Host-side Scan Context images via the native library.

    Input-pipeline descriptor prep: the max-height polar binning is
    scatter-shaped work (~45% of the device replay chunk as a dense
    compare); on the host it is one pass over the points, threaded over
    frames, overlapping the previous chunk's device compute. Semantics
    mirror descriptors/scan_context.make (reference
    ``include/descriptor.h:1404-1461``) up to ~1-ulp atan2 boundary
    assignment; see tests/test_native_loader.py.

    xyz [B, N, 3] float32 (C-contiguous); mask [B, N] bool or None (all
    valid). Returns [B, num_rings, num_sectors] float32, or None when the
    native library is unavailable (callers fall back to the device path).
    """
    lib = load_library()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, np.float32)
    B, N = xyz.shape[0], xyz.shape[1]
    out = np.empty((B, num_rings, num_sectors), np.float32)
    if mask is None:
        mask_ptr = ctypes.POINTER(ctypes.c_ubyte)()
    else:
        mask = np.ascontiguousarray(mask, np.uint8)
        mask_ptr = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    lib.sc_images_batch(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask_ptr,
        B, N, num_rings, num_sectors,
        float(max_radius), float(lidar_height),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads),
    )
    return out


class NativeScanLoader:
    """In-order prefetching reader over a list of .bin paths.

    Yields (xyz [capacity, 3] float32 padded with ``pad_value``, n_valid).
    """

    def __init__(
        self,
        paths: list[str],
        capacity: int = 131072,
        pad_value: float = 1e6,
        workers: int = 2,
        queue_depth: int = 4,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError(
                "native loader unavailable (no toolchain); use kitti.read_velodyne_bin"
            )
        self._lib = lib
        self.capacity = capacity
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.loader_create(
            arr, len(paths), capacity, pad_value, workers, queue_depth
        )
        self._n = len(paths)
        self._done = False

    def __iter__(self):
        buf = np.empty((self.capacity, 3), np.float32)
        while True:
            n = self._lib.loader_next(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            if n == -2:
                return
            if n < 0:
                raise IOError("native loader: scan read failed")
            yield buf.copy(), n

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
