"""The on-card check CLI (geometric_adv_tpu_torch/cli/verify_cuda.py) stays
importable and fails cleanly off the card, as tests/test_verify_tpu.py pins
for the TPU CLI; its checks run on the card (chip_smoke.py runs it as a
stage)."""

import pytest
import torch

from geometric_adv_tpu_torch.cli import verify_cuda


def test_exits_nonzero_off_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit) as exc:
        verify_cuda.main()
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "[FAIL] backend is CUDA" in out
    # the failure list is cleared at the start of every run
    verify_cuda._FAILURES.clear()
