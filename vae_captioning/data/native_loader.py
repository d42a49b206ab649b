"""ctypes bindings for the native batch loader (native/batchloader.cpp)
plus the packed raw record format.

``RawImageStore`` is a drop-in alternative to ``Hdf5ImageStore``
(same ``get_batch``) backed by a memory-mapped flat uint8 file and a
C++ thread-pool gather with next-batch prefetch — the fine-tune input
pipeline's native fast path.  ``pack_images_to_raw`` is the matching
packer (``preprocess.py`` equivalent, raw format).

The shared library is built on first use with g++ (cached next to the
source); everything degrades gracefully to numpy if the toolchain is
unavailable.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libbatchloader.so")

_lib = None


def _build_library() -> Optional[str]:
    src = os.path.join(_NATIVE_DIR, "batchloader.cpp")
    if not os.path.exists(src):
        return None
    if os.path.exists(_LIB_PATH) and (os.path.getmtime(_LIB_PATH)
                                      >= os.path.getmtime(src)):
        return _LIB_PATH
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-o", _LIB_PATH, src],
            check=True, capture_output=True)
        return _LIB_PATH
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None


def load_library():
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.bl_open.restype = ctypes.c_void_p
    lib.bl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int]
    lib.bl_gather.restype = ctypes.c_int
    lib.bl_gather.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_int64, ctypes.c_void_p]
    lib.bl_prefetch.restype = ctypes.c_int
    lib.bl_prefetch.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.c_int64]
    lib.bl_num_records.restype = ctypes.c_int64
    lib.bl_num_records.argtypes = [ctypes.c_void_p]
    lib.bl_close.restype = None
    lib.bl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


# ----------------------------------------------------------------------
# packed raw record format: <name>.bin (N * record flat uint8) +
# <name>.bin.meta.json {shape, names→row}
# ----------------------------------------------------------------------

def pack_images_to_raw(image_dirs: Sequence[str], output_bin: str,
                       size: int = 224) -> Dict[str, int]:
    """Pack every jpg into one flat uint8 record file."""
    from vae_captioning.data.images import load_image

    paths = []
    for d in image_dirs:
        paths.extend(sorted(glob(os.path.join(d, "*.jpg"))))
    if not paths:
        raise FileNotFoundError(f"no jpgs under {image_dirs}")
    os.makedirs(os.path.dirname(os.path.abspath(output_bin)), exist_ok=True)
    name_to_row: Dict[str, int] = {}
    with open(output_bin, "wb") as f:
        for i, p in enumerate(paths):
            f.write(load_image(p, size).astype(np.uint8).tobytes())
            name_to_row[os.path.basename(p)] = i
    meta = {"record_shape": [size, size, 3], "dtype": "uint8",
            "names": name_to_row}
    with open(output_bin + ".meta.json", "w") as f:
        json.dump(meta, f)
    return name_to_row


class RawImageStore:
    """mmap + native thread-pool gather over a packed raw record file."""

    def __init__(self, bin_path: str, num_threads: int = 8,
                 force_numpy: bool = False):
        with open(bin_path + ".meta.json") as f:
            meta = json.load(f)
        self.record_shape = tuple(meta["record_shape"])
        self.name_to_row: Dict[str, int] = meta["names"]
        self._record_size = int(np.prod(self.record_shape))
        self._n = len(self.name_to_row)
        self._handle = None
        self._lib = None if force_numpy else load_library()
        if self._lib is not None:
            self._handle = self._lib.bl_open(
                bin_path.encode(), self._n, self._record_size, num_threads)
            if not self._handle:
                self._lib = None
        if self._lib is None:  # numpy mmap fallback
            self._mm = np.memmap(bin_path, dtype=np.uint8, mode="r",
                                 shape=(self._n, *self.record_shape))

    def __len__(self) -> int:
        return self._n

    def _rows(self, filenames: Sequence[str]) -> np.ndarray:
        return np.asarray(
            [self.name_to_row[os.path.basename(f)] for f in filenames],
            dtype=np.int64)

    def get_batch(self, filenames: Sequence[str]) -> np.ndarray:
        """Gather images as uint8 [B, H, W, 3].

        uint8, not float32: raw pixels stay 1 byte/channel through host
        batching AND the host→device transfer (4× less traffic — the
        transfer dominated the fine-tune step at 19 MB/step f32,
        benchmarks/bench_finetune_io.py); VGG16 casts to its compute
        dtype on device (models/vgg16.py:50), where the uint8→bf16 cast
        of [0, 255] integers is value-identical to float32→bf16."""
        rows = self._rows(filenames)
        if self._lib is not None:
            out = np.empty((len(rows), *self.record_shape), np.uint8)
            rc = self._lib.bl_gather(
                self._handle,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(rows), out.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"bl_gather failed with code {rc}")
            return out
        return np.asarray(self._mm[rows])

    def prefetch(self, filenames: Sequence[str]) -> None:
        """Warm the page cache for an upcoming batch (no-op on fallback)."""
        if self._lib is None:
            return
        rows = self._rows(filenames)
        self._lib.bl_prefetch(
            self._handle, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(rows))

    def close(self) -> None:
        if self._lib is not None and self._handle:
            self._lib.bl_close(self._handle)
            self._handle = None


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Pack COCO jpgs into the raw "
                                "record format for the native loader")
    p.add_argument("--image_dirs", nargs="+", required=True)
    p.add_argument("--output", required=True, help="output .bin path")
    args = p.parse_args(argv)
    index = pack_images_to_raw(args.image_dirs, args.output)
    print(f"packed {len(index)} images into {args.output}")


if __name__ == "__main__":
    main()
