"""The port's precision options: ``--matmul_precision`` (cli/common.py) and
the bfloat16 victim (``ae_dtype="bfloat16"``, models/layers.py).

- every string the JAX package passes to jax_default_matmul_precision maps
  to its stated TF32 setting on the card and to full float32 on the CPU
  (as XLA:CPU); any other string raises ValueError; the stages restore the
  flags they set;
- the bfloat16 victim against the JAX package's bfloat16 victim on bridged
  weights. Bar, from a measurement (this file's victims and the full width,
  on the CPU): the reconstructions and codes equal, the pre-symmetry map
  within one bfloat16 step (2^-8 relative) of the largest entry on
  0.03% of its entries; held at 2^-8 of the largest entry and at most 0.5%
  of the entries off. XLA's CPU dot and oneDNN's round a bfloat16 product's
  float32 sum apart where it lies on a rounding edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.models import PointNetAE as JaxAE
from geometric_adv_tpu_torch.cli import common
from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE

CARD = {
    None: False, "float32": False, "highest": False,
    "tensorfloat32": True, "high": True, "bfloat16_3x": True,
    "bfloat16": True, "default": True,
}


@pytest.mark.parametrize("precision", list(CARD))
def test_matmul_precision_maps_as_documented(precision):
    assert common.matmul_tf32(precision, "cuda") is CARD[precision]
    assert common.matmul_tf32(precision, "cpu") is False
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        assert common.resolve_device("cpu", precision).type == "cpu"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("precision", ["fp8", "TF32", "", "float64"])
def test_unknown_matmul_precision_raises(precision):
    with pytest.raises(ValueError, match="--matmul_precision"):
        common.resolve_device("cpu", precision)


def test_stages_restore_the_tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with common.restored_tf32_flags():
            common.resolve_device("cpu", "float32")
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def victims(n, bneck, enc, dec, seed=3):
    jmodel = JaxAE(n_points=n, bneck_size=bneck, encoder_filters=enc,
                   decoder_sizes=dec, dtype=jnp.bfloat16)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, 3)), train=False)
    stats = jax.tree.map(lambda a: a + 0.3 * jnp.abs(a) + 0.01, variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    model = PointNetAE(n_points=n, bneck_size=bneck, encoder_filters=enc,
                       decoder_sizes=dec, dtype="bfloat16")
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    return jmodel, variables, model.eval()


def assert_bf16_close(got, want):
    step = 2.0 ** -8 * np.abs(want).max()
    off = got != want
    assert np.abs(got - want).max() <= step
    assert off.mean() <= 5e-3, off.mean()


@pytest.mark.parametrize("n,bneck,enc,dec", [
    (64, 16, [16, 32, 16], [32, 32]),
    (256, 128, [64, 128, 128, 256, 128], [256, 256]),
], ids=["small", "full_width"])
def test_bf16_victim_matches_jax_bf16(n, bneck, enc, dec):
    jmodel, variables, model = victims(n, bneck, enc, dec)
    x = np.random.RandomState(0).randn(4, n, 3).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert_bf16_close(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def test_bf16_victim_train_mode_and_trainer_outputs_float32():
    """A train-mode forward's BN statistics (reduced in float32, as flax's)
    against flax's, and the trainer's bfloat16 victim: float32 numpy
    outputs and a loss computed in float32."""
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    jmodel, variables, model = victims(64, 16, [16, 32, 16], [32, 32])
    x = np.random.RandomState(1).randn(4, 64, 3).astype(np.float32)
    _, upd = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    for name, st in upd["batch_stats"]["encoder"].items():
        bn = getattr(model.encoder, name)
        np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), st["var"], rtol=1e-5, atol=1e-6)

    conf = Configuration(n_input=[64, 3], bneck_size=16, encoder_filters=[16, 32, 16],
                         decoder_sizes=[32, 32], ae_dtype="bfloat16", saver_step=None)
    trainer = AETrainer(conf, "cpu")
    assert trainer.model.dtype == torch.bfloat16
    recon, loss = trainer.reconstruct(x)
    assert recon.dtype == np.float32 and np.isfinite(loss)
    assert trainer.get_latent_vectors(x).dtype == np.float32
    _, step_loss = trainer.partial_fit(x)
    assert np.isfinite(step_loss)
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    with pytest.raises(ValueError, match="compute dtype"):
        AETrainer(Configuration(n_input=[64, 3], ae_dtype="float16"), "cpu")
