"""The float32 matmul precision a run holds the program and the reference to,
set by the benchmark itself and never read from the program.

A configuration states ``"tf32": false`` (float32 throughout) or true. The
harness sets the process's flags to it before the program's set-up, reads
them again once the window has closed (a program that changed them departs
from its configuration, and the run is not correct), and runs every
reference computation inside ``pinned(False)``: the reference is float32
with TF32 off whatever the program left behind. The control runs the
reference inside ``pinned(True)``.
"""

from __future__ import annotations

import contextlib

import torch


def stated(tf32: bool) -> dict:
    """The flags of a run in float32 with TF32 on or off."""
    return {"cuda.matmul.allow_tf32": bool(tf32), "cudnn.allow_tf32": bool(tf32),
            "float32_matmul_precision": "high" if tf32 else "highest"}


def read() -> dict:
    return {"cuda.matmul.allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn.allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def apply(flags: dict) -> None:
    torch.set_float32_matmul_precision(flags["float32_matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]


def departures(tf32: bool) -> list:
    """The flags that differ from the stated precision, as "name: now, stated"."""
    want, now = stated(tf32), read()
    return [f"{k}: {now[k]}, stated {want[k]}" for k in want if now[k] != want[k]]


@contextlib.contextmanager
def pinned(tf32: bool = False):
    """Run the block at the given precision, then put the flags back."""
    saved = read()
    apply(stated(tf32))
    try:
        yield
    finally:
        apply(saved)
