"""The rest of the port's ``AETrainer`` (reconstruct, transform, decode,
evaluate, embedding_at_layer, interpolate, build_trainer_from_checkpoint)
and ``ConvUpsampleDecoder`` against the JAX package's, with the JAX weights
bridged into the port.

Bar: tests/test_torch_model_ae.py's, rtol 1e-5 / atol 1e-5 (the two
frameworks' CPU matmuls sum in different orders); the evaluation loss and
the augmented feeds, drawn from numpy's global stream seeded alike, too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.data.datasets import PointCloudDataSet as JaxDataSet
from geometric_adv_tpu.models.layers import ConvUpsampleDecoder as JaxConvUp
from geometric_adv_tpu.train import AETrainer as JaxTrainer
from geometric_adv_tpu.train import Configuration as JaxConf
from geometric_adv_tpu_torch.data.datasets import PointCloudDataSet
from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.models.layers import ConvUpsampleDecoder
from geometric_adv_tpu_torch.train import checkpoint as ckpt
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.train.trainer import AETrainer, build_trainer_from_checkpoint

TOL = dict(rtol=1e-5, atol=1e-5)
N = 32
ARCH = dict(n_input=[N, 3], bneck_size=8, encoder_filters=[16, 8],
            decoder_sizes=[16, 16], batch_size=4, saver_step=None)


def trainers(**extra):
    """The JAX trainer (seed 0) and the port's with its weights bridged."""
    jt = JaxTrainer(JaxConf(**ARCH, **extra), seed=0)
    pt = AETrainer(Configuration(**ARCH, **extra), "cpu")
    params = jax.tree.map(np.asarray, jt.state.params)
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.3 * np.abs(np.asarray(a)) + 0.01,
                         jt.state.batch_stats)
    jt.state = jt.state.replace(batch_stats=stats)
    pt.model.load_state_dict(state_dict_from_flax(params, stats))
    return jt, pt


def clouds(k, seed=0):
    return np.random.RandomState(seed).rand(k, N, 3).astype(np.float32) - 0.5


def test_reconstruct_transform_decode_interpolate():
    jt, pt = trainers()
    x, gt = clouds(5), clouds(5, seed=1)
    for kw in (dict(), dict(gt=gt), dict(compute_loss=False)):
        (r, loss), (jr, jloss) = pt.reconstruct(x, **kw), jt.reconstruct(x, **kw)
        np.testing.assert_allclose(r, jr, **TOL)
        assert (loss is None) == (jloss is None)
        if loss is not None:
            np.testing.assert_allclose(loss, jloss, **TOL)
    z = pt.transform(x)
    np.testing.assert_allclose(z, jt.transform(x), **TOL)
    np.testing.assert_allclose(pt.decode(z), jt.decode(z), **TOL)
    np.testing.assert_allclose(pt.decode(z[0]), jt.decode(z[0]), **TOL)  # one code
    got = pt.interpolate(x[0], x[1], 3)
    assert got.shape == (5, N, 3)
    np.testing.assert_allclose(got, jt.interpolate(x[0], x[1], 3), **TOL)


@pytest.mark.parametrize("layer_path", [
    None, ("decoder", "fc_0", "__call__"), ("encoder", "bn_1", "__call__"),
    ("encoder", "__call__")])
def test_embedding_at_layer(layer_path):
    jt, pt = trainers()
    x = clouds(7)
    got = pt.embedding_at_layer(x, layer_path, batch_size=3)
    want = jt.embedding_at_layer(x, layer_path, batch_size=3)
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, want, **TOL)


def test_embedding_at_layer_rejects_a_method_path():
    _, pt = trainers()
    with pytest.raises(ValueError, match="__call__"):
        pt.embedding_at_layer(clouds(2), ("decoder", "fc_0", "decode"))


@pytest.mark.parametrize("case", ["plain", "augmented", "denoising", "denoising_pre_aug"])
def test_evaluate(case):
    """evaluate's branches (reference: src/autoencoder.py:229-261): the
    full-set feed, augmented by numpy's seeded stream, reconstructed against
    itself or, when denoising, against the clean original."""
    extra = {}
    if case == "augmented":
        extra = dict(gauss_augment={"mu": 0.0, "sigma": 0.01}, z_rotate=True)
    elif case.startswith("denoising"):
        extra = dict(is_denoising=True, gauss_augment={"mu": 0.0, "sigma": 0.01})
    jt, pt = trainers(**extra)
    pcs = clouds(9)
    noise = pcs + 0.01 * clouds(9, seed=2) if case.startswith("denoising") else None
    labels = np.arange(9)
    pre = case == "denoising_pre_aug"
    outs = []
    for trainer, cls in ((pt, PointCloudDataSet), (jt, JaxDataSet)):
        data = cls(pcs, noise=noise, labels=labels, init_shuffle=False)
        np.random.seed(4)
        outs.append(trainer.evaluate(data, ret_pre_augmentation=pre))
    got, want = outs
    assert len(got) == len(want) == (6 if pre else 5)
    np.testing.assert_allclose(got[0], want[0], **TOL)  # reconstructions
    np.testing.assert_allclose(got[1], want[1], **TOL)  # loss
    for g, w in zip(got[2:], want[2:]):  # feed, ids, original (, pre-augmentation)
        np.testing.assert_array_equal(g, w)


def test_build_trainer_from_checkpoint(tmp_path):
    _, pt = trainers()
    pt.epoch = 3
    pt.save(str(tmp_path))
    conf = Configuration(**ARCH)
    got = build_trainer_from_checkpoint(conf, str(tmp_path), device="cpu")
    assert got.epoch == 3 and ckpt.latest_epoch(str(tmp_path)) == 3
    for k, v in pt.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v)
    x = clouds(3)
    np.testing.assert_array_equal(got.get_reconstructions(x), pt.get_reconstructions(x))
    with pytest.raises(FileNotFoundError):
        build_trainer_from_checkpoint(conf, str(tmp_path / "empty"), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(features=(16, 16, 3), upsample_sizes=(2, None, 3)),
    dict(features=(8, 3), upsample_sizes=None, bn_finish=True),
    dict(features=(16, 3), upsample_sizes=(None, 2), use_bn=False),
], ids=["upsampled", "bn_finish", "no_bn"])
def test_conv_upsample_decoder_matches_jax(kw):
    """Eval mode and a train-mode step's output and BN statistics against
    flax, with the flax tree bridged (models/bridge.py)."""
    jm = JaxConvUp(**kw)
    x = np.random.RandomState(0).randn(2, 5, 4).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    pm = ConvUpsampleDecoder(4, **kw)
    pm.load_state_dict(state_dict_from_flax(params, stats))
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    want, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for name, st in upd.get("batch_stats", {}).items():
        bn = getattr(pm, name)
        np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"], **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), st["var"], **TOL)
