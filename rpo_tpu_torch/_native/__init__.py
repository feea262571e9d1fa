"""ctypes binding and build at first use of the native image pipeline.

The port's own copy of ``rpo_tpu/_native``: ``image_pipeline.cpp`` beside
this file compiles with g++ (it links libjpeg) into
``build/rpo_tpu_torch/librpo_torch_image.so`` at the repository root
(``.gitignore`` lists ``build/``) the first time a caller asks for it,
never at import, and again whenever the library is older than the source.
Every caller falls back to the Pillow path, per image, when the library
is unavailable (no compiler, no libjpeg headers) or refuses a file (not
a JPEG, corrupt); ``RPO_TPU_NO_NATIVE=1`` turns it off, as in the JAX
package.

This is host code, not a kernel of the card: it lives outside ``ops/``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

_SRC = str(Path(__file__).resolve().parent / "image_pipeline.cpp")
_SO = str(Path(__file__).resolve().parents[2] / "build" / "rpo_tpu_torch" / "librpo_torch_image.so")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False
build_log = ""  # what the last build printed (the compiler's errors)


def _build() -> bool:
    # Link into a temporary file and rename it into place: os.replace
    # gives _SO a new inode, so a retried CDLL(_SO) loads the new library
    # instead of the loader's cached handle for the old (stale, still
    # mapped) one.
    global build_log
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.tmp.{os.getpid()}"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp, "-ljpeg", "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as exc:  # no g++, or it hung
        build_log = str(exc)
        return False
    build_log = res.stderr
    if res.returncode != 0:
        print(f"rpo_tpu_torch native build failed:\n{res.stderr}", file=sys.stderr)
        return False
    try:
        os.replace(tmp, _SO)
    except OSError as exc:
        build_log = str(exc)
        return False
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built if needed; None where it is unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed or os.environ.get("RPO_TPU_NO_NATIVE") == "1":
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
            _bind(lib)
        except (OSError, AttributeError):
            # AttributeError: a stale library (a copied or touched file
            # whose mtime beats the source) without a newer symbol: build
            # once from the source, else fall back to the Pillow path.
            # The dynamic loader hands back the handle it already has for
            # a path it has loaded, so the new library (a new inode, by
            # _build's rename) is loaded through another spelling of it.
            try:
                if not _build():
                    raise OSError("rebuild failed")
                lib = ctypes.CDLL(os.path.join(os.path.dirname(_SO), os.curdir,
                                               os.path.basename(_SO)))
                _bind(lib)
            except (OSError, AttributeError):
                _build_failed = True
                return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rpo_eval_preprocess.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p]
    lib.rpo_eval_preprocess.restype = ctypes.c_int
    lib.rpo_train_preprocess.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u8p,
    ]
    lib.rpo_train_preprocess.restype = ctypes.c_int
    lib.rpo_image_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.rpo_image_size.restype = ctypes.c_int
    lib.rpo_eval_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_int,
    ]
    lib.rpo_eval_preprocess_batch.restype = ctypes.c_int
    lib.rpo_train_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int), u8p, ctypes.c_int,
        ctypes.c_int, u8p, u8p, ctypes.c_int,
    ]
    lib.rpo_train_preprocess_batch.restype = ctypes.c_int
