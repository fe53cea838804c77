"""Build, load and bind the hand-written CUDA kernels (``csrc/*.cu``).

Every ``*.cu`` source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` the first time a kernel wrapper is called: one ``nvcc -c`` per
source, all started together, then one link into a single shared library
with a plain C interface, in ``build/kernels/`` at the repository root. The
library's name carries a hash of every file under ``csrc/`` (the shared
headers such as ``sqdist.cuh`` included) and of the flags, so a changed
source or header builds a new library and an unchanged tree reuses it.
Nothing is compiled when this module is imported.

The wrapper modules share the checks here: ``ops/cuda/chamfer.py`` (K1 K2
``nn_distance[_values]_cuda``, K3 ``chamfer_grad1_cuda``, K4
``chamfer_grad1_vpu_cuda``, K5 ``chamfer_loss_payloads_cuda``, K8
``nn_direction_hier_cuda``) and ``ops/cuda/emd.py`` (K6, K7). Each wrapper
checks device, dtype, shape and contiguity and raises on anything else,
allocates its outputs with ``torch.empty``, launches on the current CUDA
stream without synchronising, raises if a launch was refused, and counts its
launches. There is no fallback: a CPU tensor, a failed build or a refused
launch raises.
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
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fp = ctypes.POINTER(ctypes.c_float)
# argtypes of every C entry point; all return a cudaError_t as int
SIGNATURES = {
    "gat_nn_distance": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
    "gat_nn_distance_values": [_p, _p, _p, _p, _i, _i, _i, _p],
    "gat_chamfer_grad1": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
    "gat_chamfer_grad1_vpu": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
    "gat_chamfer_loss_payloads": [_p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                                  _p],
    "gat_nn_direction_hier": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
    "gat_emd_sweep_block": [_p, _p, _p, _p, _p, _i, _i, _i, _f, _f, _fp, _i, _p],
    "gat_emd_sweep_tiled": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _f, _f,
                            _fp, _i, _p, _p],
    "gat_emd_numerics_scan": [_p, _p],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of the build this process ran (ptxas usage)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the kernels are built "
            "from csrc/ with the CUDA toolkit"
        )
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(src.relative_to(CSRC).as_posix().encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgat_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise with the output of any that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"({rc}) {' '.join(c)}\n{o}" for c, rc, o in failed))
    return "".join(outs)


def _build(out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = out.with_suffix(f".{os.getpid()}")
    objs = [f"{stem}.{src.stem}.o" for src in sources()]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                    for src, obj in zip(sources(), objs)])
    tmp = f"{stem}.tmp"
    log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-shared", "-o", tmp, *objs]])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out)
    return log


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            build_log = _build(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {rc} "
            f"({torch.cuda.get_device_name()})"
        )


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cloud_sizes(xyz1: torch.Tensor, xyz2: torch.Tensor) -> tuple[int, int, int]:
    """(b, n, m) of two f32 cloud batches [b, n, 3], [b, m, 3] on one card."""
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
    check(xyz1, "xyz1", torch.float32, (b, n, 3), xyz1.device)
    check(xyz2, "xyz2", torch.float32, (b, m, 3), xyz1.device)
    return b, n, m


def counted(fn):
    """Give a wrapper its launch count (a plain int attribute)."""
    fn.launches = 0
    return fn


def reset_launch_counts(wrappers) -> None:
    for fn in wrappers:
        fn.launches = 0


def launch_counts(wrappers) -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in wrappers}
