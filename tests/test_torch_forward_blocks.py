"""The victim's eval-mode batched forward does not depend on the batch its
clouds sit in (``AETrainer._batched_forward``, FORWARD_BLOCK).

The JAX package's batched forward is bit-identical across batch sizes on
the CPU (geometric_adv_tpu/train/trainer.py:177-178). The port runs every
eval forward over zero-padded blocks of FORWARD_BLOCK clouds, so that each
GEMM has one shape whatever the batch: here three probe clouds, placed at
any offset in a batch of 1-40 other clouds and chunked at any
``batch_size``, give the same bits as alone, through every output of the
batched forward and the functions built on it, for a chamfer and an EMD
victim and a bfloat16 one.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.train.trainer import FORWARD_BLOCK, AETrainer

N_POINTS = 64
CLOUDS = np.random.RandomState(0).rand(60, N_POINTS, 3).astype(np.float32) - 0.5
PROBE = CLOUDS[:3]


def victim(loss, dtype="float32"):
    """A small victim whose batch norm statistics are not the identity."""
    conf = Configuration(n_input=[N_POINTS, 3], bneck_size=16,
                         encoder_filters=[32, 64, 16], decoder_sizes=[64, 128],
                         loss=loss, ae_dtype=dtype)
    trainer = AETrainer(conf, "cpu", seed=7)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in trainer.model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return trainer


VICTIMS = {"chamfer": victim("chamfer"), "emd": victim("emd"),
           "bfloat16": victim("chamfer", "bfloat16")}


def outputs(trainer, x, batch_size, rows):
    """Every output of the batched forward for ``x``, cut to ``rows``."""
    out = trainer._batched_forward(
        x, batch_size=batch_size,
        outputs=("recon", "z", "pre", "loss", "pre_argmax", "pre_max"))
    return {k: v[rows] for k, v in out.items()}


@pytest.fixture(scope="module")
def alone():
    """The probe clouds' outputs alone, all in one thread (the tests'
    workers share the host), which the module's tests keep."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {name: outputs(t, PROBE, 250, slice(0, 3)) for name, t in VICTIMS.items()}
    torch.set_num_threads(threads)


@settings(max_examples=30, deadline=None)
@given(name=st.sampled_from(sorted(VICTIMS)), others=st.integers(1, 40),
       offset=st.integers(0, 40), batch_size=st.sampled_from([1, 3, 7, 16, 17, 250]))
def test_batched_forward_is_batch_invariant(alone, name, others, offset, batch_size):
    offset = min(offset, others)
    rest = CLOUDS[3:3 + others]
    x = np.concatenate([rest[:offset], PROBE, rest[offset:]])
    got = outputs(VICTIMS[name], x, batch_size, slice(offset, offset + 3))
    for k, want in alone[name].items():
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.mark.parametrize("name", sorted(VICTIMS))
def test_twelve_at_once_equal_rows_of_four(alone, name):
    """The drift once measured on the EMD slice victim: 12 clouds in one
    call against the same clouds in calls of 4, through the functions built
    on the batched forward (in the ``alone`` fixture's one thread)."""
    trainer = VICTIMS[name]
    x = CLOUDS[:12]

    def calls(a):
        return [trainer.get_reconstructions(a), trainer.get_loss_per_pc(a),
                trainer.get_latent_vectors(a), trainer.get_pre_symmetry_data(a),
                *trainer.get_pre_symmetry_argmax(a), trainer.reconstruct(a)[0],
                trainer.transform(a)]

    at_once = calls(x)
    in_fours = [np.concatenate(v) for v in zip(*(calls(x[i:i + 4])
                                                 for i in range(0, 12, 4)))]
    for a, b in zip(at_once, in_fours):
        np.testing.assert_array_equal(a, b)
    assert FORWARD_BLOCK > 4  # the calls of 4 are padded blocks
