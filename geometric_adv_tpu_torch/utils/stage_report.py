"""What a stage did, for the pipeline runner.

Where the environment names a file in ``GAT_STAGE_REPORT``, a stage that
imported ``cli/common.py`` writes one JSON object there when its process
exits: ``startup_s``, the seconds from the runner's spawn of the process
(``GAT_STAGE_SPAWNED``, a ``time.time()``) to the end of ``cli/common``'s
import (the interpreter, torch and the package modules loaded by then);
and, if the stage used CUDA, ``peak_device_bytes``, the current device's
``torch.cuda.max_memory_allocated()``, and ``launches``, each kernel
wrapper's launch count (``ops/cuda/``) in the process, for the wrapper
modules the stage loaded (else ``None`` and ``{}``); and ``counters``, the
program's counters (``utils/profiling.py``: the attack's pair-iterations
and refreshes, training's steps and samples). Under a process group only
the primary rank writes. ``runner_pipeline`` sets both variables and
reads the file after each stage."""

from __future__ import annotations

import atexit
import json
import os
import sys
import time

STAGE_REPORT_ENV = "GAT_STAGE_REPORT"
STAGE_SPAWNED_ENV = "GAT_STAGE_SPAWNED"
_WRAPPER_MODULES = ("geometric_adv_tpu_torch.ops.cuda.chamfer",
                    "geometric_adv_tpu_torch.ops.cuda.emd",
                    "geometric_adv_tpu_torch.ops.cuda.bn_relu")


def _write_report(path: str, startup_s: float | None = None) -> None:
    import torch

    from geometric_adv_tpu_torch.utils.profiling import counters

    peak, launches = None, {}
    if torch.cuda.is_initialized():
        peak = torch.cuda.max_memory_allocated()
        for name in _WRAPPER_MODULES:
            if sys.modules.get(name) is not None:
                launches.update(sys.modules[name].launch_counts())
    with open(path, "w") as f:
        json.dump({"startup_s": startup_s, "peak_device_bytes": peak,
                   "launches": launches, "counters": counters()}, f)


def report_stage_at_exit() -> None:
    """Registers the write at exit when ``GAT_STAGE_REPORT`` is set and this
    process is the primary rank (or the only process)."""
    from geometric_adv_tpu_torch.parallel import is_primary

    path = os.environ.get(STAGE_REPORT_ENV)
    if not path or not is_primary():
        return
    spawned = os.environ.get(STAGE_SPAWNED_ENV)
    startup_s = time.time() - float(spawned) if spawned else None
    atexit.register(_write_report, path, startup_s)
