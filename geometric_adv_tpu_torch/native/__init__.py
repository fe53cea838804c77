"""The native (C++) PLY batch loader, ``_ply_native``.

``ply_loader.cpp`` is a byte-equal copy of the JAX package's
(``geometric_adv_tpu/native/ply_loader.cpp``, pinned by
``tests/test_torch_data.py``): a CPython extension that parses whole file
lists into one float32 buffer with a thread pool. It is compiled with the
host ``g++`` the first time ``get_module`` is called, into
``build/native/`` at the repository root (gitignored), under a name that
carries a hash of the source, the flags and the interpreter's ABI tag;
nothing is compiled at import and nothing is written beside the source.

As in the JAX package the extension is optional: ``get_module`` returns
None where it cannot be built or loaded, and the callers then parse with
the pure-python ``data/ply.py``. ``build_error`` holds the reason.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "ply_loader.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_module = None
_failed = False
build_error = ""  # why the last build or load failed, "" if none did


def so_path() -> Path:
    tag = sysconfig.get_config_var("SOABI") or "native"
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS + (tag,)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"_ply_native.{tag}.{digest}.so"


def _compile() -> Path:
    out = so_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    include = sysconfig.get_paths()["include"]
    subprocess.run(
        ["g++", *GXX_FLAGS, f"-I{include}", str(SOURCE), "-o", str(tmp)],
        check=True, capture_output=True, text=True,
    )
    os.replace(tmp, out)
    return out


def get_module():
    """The extension (built on first use), or None if it cannot be had."""
    global _module, _failed, build_error
    if _module is not None or _failed:
        return _module
    with _lock:
        if _module is not None or _failed:
            return _module
        try:
            so = _compile()
            spec = importlib.util.spec_from_file_location("_ply_native", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        except (OSError, ImportError, subprocess.CalledProcessError) as e:
            _failed = True
            build_error = getattr(e, "stderr", None) or repr(e)
    return _module
