"""ctypes wrappers of the hand-written chamfer kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface the first time a wrapper is called, into
``build/kernels/`` at the repository root, keyed by a hash of the sources and
the flags (a changed source builds a new library; an unchanged one is
reused). Nothing is compiled when this module is imported.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``, launches on the
current CUDA stream without synchronising, raises if the launch was refused,
and adds one to its ``launches`` count per kernel launch. There is no
fallback: a CPU tensor, a failed build or a refused launch raises. The
plain PyTorch versions live in ``geometric_adv_tpu_torch/ops/chamfer.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("nn_distance.cu", "chamfer_grad.cu")
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of the build this process ran (ptxas usage)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the chamfer kernels "
            "are built from csrc/ with the CUDA toolkit"
        )
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgat_chamfer_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
            cmd += [str(CSRC / s) for s in SOURCES]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                    f"{res.stdout}\n{res.stderr}"
                )
            build_log = res.stdout + res.stderr
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gat_nn_distance.argtypes = [p, p, p, p, i, i, i, p]
        lib.gat_nn_distance_values.argtypes = [p, p, p, i, i, i, p]
        lib.gat_chamfer_grad1.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        for fn in (lib.gat_nn_distance, lib.gat_nn_distance_values,
                   lib.gat_chamfer_grad1):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {rc} "
            f"({torch.cuda.get_device_name()})"
        )


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cloud_sizes(xyz1: torch.Tensor, xyz2: torch.Tensor) -> tuple[int, int, int]:
    if xyz1.dim() != 3 or xyz2.dim() != 3:
        raise ValueError(
            f"clouds must be [b, n, 3] and [b, m, 3], got {tuple(xyz1.shape)} "
            f"and {tuple(xyz2.shape)}"
        )
    b, n, m = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
    if min(b, n, m) == 0:
        raise ValueError(f"empty cloud batch: b={b}, n={n}, m={m}")
    if b * max(n, m) * 3 >= 2**31:
        raise ValueError(f"cloud batch too large for int32 indexing: {b}x{max(n, m)}")
    _check(xyz1, "xyz1", torch.float32, (b, n, 3), xyz1.device)
    _check(xyz2, "xyz2", torch.float32, (b, m, 3), xyz1.device)
    return b, n, m


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def nn_distance_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """K1: (dist1 [b,n], idx1 [b,n] i32, dist2 [b,m], idx2 [b,m] i32).

    Two launches, one per direction."""
    b, n, m = _cloud_sizes(xyz1, xyz2)
    lib = load_library()
    opts = dict(device=xyz1.device)
    d1 = torch.empty((b, n), dtype=torch.float32, **opts)
    i1 = torch.empty((b, n), dtype=torch.int32, **opts)
    d2 = torch.empty((b, m), dtype=torch.float32, **opts)
    i2 = torch.empty((b, m), dtype=torch.int32, **opts)
    with torch.cuda.device(xyz1.device):
        stream = torch.cuda.current_stream().cuda_stream
        for q, o, d, i, nq, no in ((xyz1, xyz2, d1, i1, n, m),
                                   (xyz2, xyz1, d2, i2, m, n)):
            _check_launch(
                lib.gat_nn_distance(_ptr(q), _ptr(o), _ptr(d), _ptr(i), b, nq,
                                    no, stream),
                "nn_distance",
            )
            nn_distance_cuda.launches += 1
    return d1, i1, d2, i2


def nn_distance_values_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """K2: (dist1 [b,n], dist2 [b,m]) without the argmin. Two launches."""
    b, n, m = _cloud_sizes(xyz1, xyz2)
    lib = load_library()
    d1 = torch.empty((b, n), dtype=torch.float32, device=xyz1.device)
    d2 = torch.empty((b, m), dtype=torch.float32, device=xyz1.device)
    with torch.cuda.device(xyz1.device):
        stream = torch.cuda.current_stream().cuda_stream
        for q, o, d, nq, no in ((xyz1, xyz2, d1, n, m), (xyz2, xyz1, d2, m, n)):
            _check_launch(
                lib.gat_nn_distance_values(_ptr(q), _ptr(o), _ptr(d), b, nq,
                                           no, stream),
                "nn_distance_values",
            )
            nn_distance_values_cuda.launches += 1
    return d1, d2


def chamfer_grad1_cuda(xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    """K3: gradient of sum(g1*dist1) + sum(g2*dist2) wrt xyz1, [b, n, 3]."""
    b, n, m = _cloud_sizes(xyz1, xyz2)
    dev = xyz1.device
    _check(idx1, "idx1", torch.int32, (b, n), dev)
    _check(idx2, "idx2", torch.int32, (b, m), dev)
    _check(g1, "g1", torch.float32, (b, n), dev)
    _check(g2, "g2", torch.float32, (b, m), dev)
    lib = load_library()
    out = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _check_launch(
            lib.gat_chamfer_grad1(
                _ptr(xyz1), _ptr(xyz2), _ptr(idx1), _ptr(idx2), _ptr(g1),
                _ptr(g2), _ptr(out), b, n, m,
                torch.cuda.current_stream().cuda_stream,
            ),
            "chamfer_grad1",
        )
        chamfer_grad1_cuda.launches += 1
    return out


WRAPPERS = (nn_distance_cuda, nn_distance_values_cuda, chamfer_grad1_cuda)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


reset_launch_counts()
