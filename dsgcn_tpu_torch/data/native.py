"""ctypes bindings of the native (C++) data-pipeline kernels: the port of
``dsgcn_tpu/data/native.py`` over its own copy of the source,
``csrc/skel_ops.cpp`` (``PreNormalize3D``'s frame selection, centering and
alignment; the bone features).

The library is built at first use with ``g++ -O3 -shared -fPIC`` (JAX's
flags, so both give the same bits) into ``build/native`` at the repository
root, named by a hash of the source and flags, so an edited source is never
served from a stale build; processes sharing the directory build it once
(a file lock).  A failed build raises with the compiler's message: nothing
falls back to the numpy path quietly.  ``prenormalize3d`` returns None for
input the library does not take (C != 3 or more than two bodies), as
JAX's does; the caller then takes the numpy path.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "skel_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libskel_ops-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless a build of this source exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data kernels "
                           "(use_native=True) need a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}")
        proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The library, built and loaded on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i = ctypes.c_int
            lib.prenormalize3d.restype = i
            lib.prenormalize3d.argtypes = [fp, i, i, i, i, i, i, i, i, i,
                                           fp, fp]
            lib.joint_to_bone.restype = None
            lib.joint_to_bone.argtypes = [fp, i, i, i, i, ip, i, fp]
            _lib = lib
        return _lib


def prenormalize3d(keypoint: np.ndarray, align_spine: bool = True,
                   align_center: bool = True, zaxis=(0, 1), xaxis=(8, 4)
                   ) -> Optional[Tuple[np.ndarray, int, np.ndarray]]:
    """Native ``PreNormalize3D``: (kept (M, T_new, V, 3) float32, T_new,
    the body center), or None where the input is not the library's
    (C != 3, more than two bodies)."""
    kp = np.ascontiguousarray(keypoint, dtype=np.float32)
    M, T, V, C = kp.shape
    if C != 3 or M > 2:
        return None
    if align_spine and not all(0 <= j < V for j in (*zaxis, *xaxis)):
        raise IndexError(f"PreNormalize3D axes {zaxis}, {xaxis} outside "
                         f"the {V} joints")
    out = np.empty_like(kp)
    center = np.zeros(3, np.float32)
    t_new = get_lib().prenormalize3d(kp, M, T, V, int(align_spine),
                                     int(align_center), zaxis[0], zaxis[1],
                                     xaxis[0], xaxis[1], out, center)
    if t_new < 0:
        return None
    return out[:, :t_new].copy(), int(t_new), center


def joint_to_bone(keypoint: np.ndarray, pairs) -> np.ndarray:
    """Bone features: out[..., v1, :] = kp[..., v1, :] - kp[..., v2, :] for
    each (v1, v2) of ``pairs``, zero elsewhere; float32."""
    kp = np.ascontiguousarray(keypoint, dtype=np.float32)
    M, T, V, C = kp.shape
    pairs_arr = np.ascontiguousarray(np.asarray(pairs, np.int32))
    if pairs_arr.size and not (0 <= pairs_arr.min()
                               and pairs_arr.max() < V):
        raise IndexError(f"bone pairs outside the {V} joints")
    out = np.empty_like(kp)
    get_lib().joint_to_bone(kp, M, T, V, C, pairs_arr.reshape(-1),
                            len(pairs_arr), out)
    return out
