"""The port's reference-checkpoint importers (geometric_adv_tpu_torch/train/
import_tf.py, import_torch.py and cli/import_reference_ckpt.py) against the
JAX package's, on the reference-named variables of tests/test_import_tf.py
and tests/test_import_torch.py.

- the name mappings: the port's tree equals JAX's, and the bridged state
  dicts are equal exactly and load into the port's models;
- the error paths raise with JAX's messages;
- the torch importers' round trips for AtlasNet and FoldingNet (checkpoint,
  arch.json, restore; AtlasNet's forward against tests/test_import_torch.py's
  numpy forward at its bar, rtol 1e-5 / atol 1e-5) and the CLI's branches;
- slow, where tensorflow exists (as tests/test_import_tf.py): the TF round
  trips of the victim and the classifier, and the imported victim's attack
  replayed against tests/golden/adversarial_metrics_imported_tf_sphere.npy
  at the port's golden bars (tests/test_torch_slice.py: rtol 2e-4 /
  atol 1e-6).
"""

import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

import test_import_tf as jtf
import test_import_torch as jtorch
from geometric_adv_tpu.train import import_tf as jax_tf
from geometric_adv_tpu.train import import_torch as jax_torch
from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.train import checkpoint as ckpt
from geometric_adv_tpu_torch.train import import_tf, import_torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def assert_state_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_ae_mapping_equals_jax_and_loads_into_the_port():
    from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE

    for kw in (dict(), dict(conv_rank4=False, epoch=None, scope="single_class_ae")):
        v = jtf.make_ref_vars(seed=1, **kw)
        got = import_tf.map_reference_ae_variables(v)
        want = jax_tf.map_reference_ae_variables(v)
        assert got[2] == want[2]
        assert_trees_equal(got[:2], want[:2])
        sd = state_dict_from_flax(*got[:2])
        assert_state_dicts_equal(sd, state_dict_from_flax(*want[:2]))
        model = PointNetAE(n_points=jtf.N_POINTS, bneck_size=jtf.ENC[-1],
                           encoder_filters=jtf.ENC, decoder_sizes=jtf.DEC[:-1])
        model.load_state_dict(sd)  # strict: every name and shape


@pytest.mark.parametrize("use_tnets", [True, False])
def test_classifier_mapping_equals_jax_and_loads_into_the_port(use_tnets):
    from geometric_adv_tpu_torch.models.pointnet_cls import PointNetClassifier

    v = jtf.make_cls_vars(seed=2, use_tnets=use_tnets)
    got = import_tf.map_reference_classifier_variables(v)
    want = jax_tf.map_reference_classifier_variables(v)
    assert got[2] == want[2] == use_tnets
    assert_trees_equal(got[:2], want[:2])
    sd = state_dict_from_flax(*got[:2])
    assert_state_dicts_equal(sd, state_dict_from_flax(*want[:2]))
    PointNetClassifier(num_classes=jtf.N_CLS, use_tnets=use_tnets).load_state_dict(sd)


def _message(fn, *args):
    try:
        fn(*args)
    except (ValueError, KeyError) as e:
        return type(e), str(e)
    raise AssertionError(f"{fn.__name__} did not raise")


def _error_cases():
    v = jtf.make_ref_vars()
    two = dict(v)
    two.update({k.replace("autoencoder/", "other/"): a for k, a in v.items()
                if k.startswith("autoencoder/encoder_conv_layer_0/")})
    one_layer = {k: a for k, a in v.items()
                 if "encoder_conv_layer_1" not in k and "encoder_conv_layer_2" not in k}
    no_dec = {k: a for k, a in v.items() if "decoder" not in k}
    bad_bn = {k: a for k, a in v.items() if "encoder_conv_layer_1_bnorm/gamma" not in k}
    cls = jtf.make_cls_vars(use_tnets=False)
    cls_bad = {k: a for k, a in cls.items() if "conv2/bn/gamma" not in k}
    return {
        "no scope": ("map_reference_ae_variables", ({"x": np.zeros(1)},)),
        "two scopes": ("detect_model_scope", (two,)),
        "one encoder layer": ("map_reference_ae_variables", (one_layer,)),
        "no decoder": ("map_reference_ae_variables", (no_dec,)),
        "incomplete bn": ("map_reference_ae_variables", (bad_bn,)),
        "conv filter": ("_dense_kernel", (np.zeros((3, 1, 2, 4)), "W")),
        "vector kernel": ("_dense_kernel", (np.zeros(4), "W")),
        "not a classifier": ("map_reference_classifier_variables", (v,)),
        "classifier bn": ("map_reference_classifier_variables", (cls_bad,)),
    }


@pytest.mark.parametrize("case", sorted(_error_cases()))
def test_tf_mapping_errors_match_jax(case):
    name, args = _error_cases()[case]
    assert _message(getattr(import_tf, name), *args) == _message(
        getattr(jax_tf, name), *args)


def test_torch_mapping_errors_match_jax():
    sd = jtorch.make_atlasnet_sd()
    cases = [
        ("map_reference_atlasnet_state", {"x": np.zeros(1)}),
        ("map_reference_atlasnet_state",
         {k: a for k, a in sd.items() if not k.startswith("decoder.decoder.1.")}
         | {"decoder.decoder.2.conv1.weight": sd["decoder.decoder.0.conv1.weight"]}),
        ("map_reference_atlasnet_state",
         {k: a for k, a in sd.items() if k != "decoder.decoder.1.conv_list.1.weight"}),
        ("map_reference_foldingnet_state", sd),
    ]
    for name, arg in cases:
        assert _message(getattr(import_torch, name), arg) == _message(
            getattr(jax_torch, name), arg)
    bad = dict(sd, **{"encoder.conv1.weight": np.zeros((64, 3, 2), np.float32)})
    assert _message(import_torch.map_reference_atlasnet_state, bad) == _message(
        jax_torch.map_reference_atlasnet_state, bad)


def test_epoch_from_prefix_and_tf_absent_message(monkeypatch):
    for prefix in ("log/a/models.ckpt-500", "model-150.ckpt", "models.ckpt",
                   "x-7", "models.ckpt-12.index"):
        assert import_tf._epoch_from_prefix(prefix) == jax_tf._epoch_from_prefix(prefix)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="needs the `tensorflow` package") as e:
        import_tf.load_tf_variables("models.ckpt-500")
    assert "geometric_adv_tpu_torch does not use TF" in str(e.value)


def test_check_against_conf(tmp_path):
    params, stats, _ = import_tf.map_reference_ae_variables(jtf.make_ref_vars())
    conf = jtf.small_conf()
    import_tf._check_against_conf(params, stats, conf)
    conf.bneck_size, conf.encoder_filters = 7, [8, 12, 7]
    with pytest.raises(ValueError, match="do not match the configuration's architecture"):
        import_tf.write_reference_ae(params, stats, str(tmp_path), 3, conf)
    assert ckpt.latest_epoch(str(tmp_path)) is None  # nothing written


def _save_sd(path, sd, epoch=None):
    tensors = {k: torch.as_tensor(v) for k, v in sd.items()}
    obj = tensors if epoch is None else {"epoch": epoch, "model": tensors,
                                         "optimizer": {}}
    torch.save(obj, path)
    return path


def test_atlasnet_torch_round_trip(tmp_path):
    """A DataParallel-prefixed network.pth of 2 SQUARE primitives (at
    tests/test_import_torch.py's small widths): imported with the arch.json
    that names them, the written state dict is JAX's mapping bridged and
    loads into the port's AtlasNet of those widths, whose forward on a fixed
    template equals that file's numpy forward of the reference network (its
    bar: rtol 1e-5 / atol 1e-5)."""
    from geometric_adv_tpu_torch.models.atlasnet import AtlasNet
    from geometric_adv_tpu_torch.transfer import load_transfer_arch

    sd = jtorch.make_atlasnet_sd(seed=3, template_dim=2)
    path = _save_sd(str(tmp_path / "network.pth"),
                    {f"module.{k}": v for k, v in sd.items()})
    out, epoch, meta = import_torch.import_reference_atlasnet_checkpoint(
        path, str(tmp_path / "t"), epoch=4)
    assert epoch == 4 and meta == jax_torch.map_reference_atlasnet_state(sd)[2]
    assert load_transfer_arch(str(tmp_path / "t")) == {
        "ae_type": "atlasnet", "nb_primitives": 2, "template_type": "SQUARE"}
    restored = ckpt.restore_checkpoint(str(tmp_path / "t"), 4)
    assert restored["epoch"] == 4 and restored["opt_state"] is None
    params, stats, _ = jax_torch.map_reference_atlasnet_state(sd)
    assert_state_dicts_equal(restored["state_dict"], state_dict_from_flax(params, stats))
    model = AtlasNet(number_points=20, nb_primitives=2, template_type="SQUARE",
                     bottleneck_size=jtorch.BNECK, hidden_neurons=jtorch.HIDDEN,
                     num_layers=jtorch.NUM_LAYERS)
    model.load_state_dict(restored["state_dict"])
    model.eval()
    x = np.random.RandomState(0).rand(2, jtorch.N_IN, 3).astype(np.float32)
    template = np.random.RandomState(1).rand(2, 10, 2).astype(np.float32)
    want, _ = jtorch.numpy_atlasnet_forward(sd, x, template)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(template))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_foldingnet_torch_round_trip(tmp_path):
    from geometric_adv_tpu_torch.transfer import get_transfer_ae, load_transfer_arch

    sd = jtorch.make_foldingnet_sd(seed=5)
    path = _save_sd(str(tmp_path / "checkpoint_9.pth"), sd, epoch=9)
    out, epoch = import_torch.import_reference_foldingnet_checkpoint(
        path, str(tmp_path / "f"))
    assert epoch == 9 and out == ckpt.checkpoint_path(str(tmp_path / "f"), 9)
    assert load_transfer_arch(str(tmp_path / "f")) == {"ae_type": "foldingnet"}
    trainer = get_transfer_ae("foldingnet", device="cpu").restore(str(tmp_path / "f"))
    params, stats = jax_torch.map_reference_foldingnet_state(sd)
    assert_state_dicts_equal(trainer.model.state_dict(), state_dict_from_flax(params, stats))
    loaded, ep = import_torch.load_torch_state_dict(path)
    want, jep = jax_torch.load_torch_state_dict(path)
    assert ep == jep == 9 and list(loaded) == list(want)
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k])
    with pytest.raises(ValueError, match="no epoch counter"):
        import_torch.import_reference_foldingnet_checkpoint(
            _save_sd(str(tmp_path / "bare.pth"), sd), str(tmp_path / "g"))


def test_cli_branches(tmp_path, capsys, monkeypatch):
    """--model atlasnet and foldingnet write the checkpoint the restore
    hint names; --reference_config with them and with the classifier, and a
    physical file name as the TF prefix, stop with JAX's messages; --model
    ae and classifier without tensorflow raise its ImportError."""
    from geometric_adv_tpu_torch.cli import import_reference_ckpt as cli

    d = str(tmp_path)
    a = _save_sd(str(tmp_path / "network.pth"), jtorch.make_atlasnet_sd())
    f = _save_sd(str(tmp_path / "checkpoint_3.pth"), jtorch.make_foldingnet_sd(), epoch=3)
    cli.main(["--project_dir", d, "--model", "atlasnet", "--reference_ckpt", a,
              "--train_folder", "log/atlas", "--epoch", "2"])
    out = capsys.readouterr().out
    assert "imported atlasnet epoch 2" in out and "NOTE: non-default architecture" in out
    assert "--transfer_ae_folder log/atlas --transfer_ae_restore_epoch 2" in out
    assert ckpt.latest_epoch(osp.join(d, "log/atlas")) == 2
    cli.main(["--project_dir", d, "--model", "foldingnet", "--reference_ckpt", f,
              "--train_folder", "log/fold"])
    assert "imported foldingnet epoch 3" in capsys.readouterr().out
    for argv, msg in (
        (["--model", "atlasnet", "--reference_config", "c.txt"], "applies to --model ae only"),
        (["--model", "classifier", "--reference_config", "c.txt"], "no Configuration object"),
        (["--reference_ckpt", "models.ckpt-500.index"], "PREFIX"),
    ):
        argv = ["--project_dir", d] + (argv if "--reference_ckpt" in argv
                                       else argv + ["--reference_ckpt", a])
        with pytest.raises(SystemExit, match=msg):
            cli.main(argv)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for model in ("ae", "classifier"):
        with pytest.raises(ImportError, match="needs the `tensorflow` package"):
            cli.main(["--project_dir", d, "--model", model, "--reference_ckpt",
                      str(tmp_path / "models.ckpt-500")])


@pytest.mark.slow
def test_tf_round_trips_through_the_cli(tmp_path, capsys):
    """A reference-format victim and classifier written by tf.compat.v1's
    Saver, imported by the port's CLI: the victim (with its
    configuration.txt) restores through build_trainer_from_checkpoint and
    reconstructs as the numpy reference forward does (tests/
    test_import_tf.py's bar), the classifier's logits equal the numpy
    reference's."""
    tf = pytest.importorskip("tensorflow")
    from geometric_adv_tpu_torch.classify import ClassifierTrainer
    from geometric_adv_tpu_torch.cli import import_reference_ckpt as cli
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import build_trainer_from_checkpoint

    d = str(tmp_path)
    v = jtf.make_ref_vars(seed=13)
    prefix = jtf._write_tf1_checkpoint(tf, v, str(tmp_path / "ref" / "models.ckpt-500"))
    conf_txt = tmp_path / "configuration.txt"
    conf_txt.write_text("".join("%30s: %s\n" % kv for kv in [
        ("n_input", [jtf.N_POINTS, 3]),
        ("encoder_args", {"n_filters": list(jtf.ENC), "b_norm": True}),
        ("decoder_args", {"layer_sizes": list(jtf.DEC), "b_norm": False}),
        ("batch_size", 2), ("loss", "chamfer")]))
    cli.main(["--project_dir", d, "--reference_ckpt", prefix, "--reference_config",
              str(conf_txt), "--train_folder", "log/victim"])
    assert "imported epoch 500" in capsys.readouterr().out
    conf = Configuration.load(osp.join(d, "log/victim/configuration"))
    assert conf.encoder_filters == list(jtf.ENC)
    trainer = build_trainer_from_checkpoint(conf, osp.join(d, "log/victim"), 500, "cpu")
    x = np.random.RandomState(2).rand(2, jtf.N_POINTS, 3).astype(np.float32)
    want, _ = jtf.numpy_reference_forward(v, x)
    np.testing.assert_allclose(trainer.get_reconstructions(x, batch_size=2), want,
                               rtol=2e-5, atol=2e-5)

    cv = jtf.make_cls_vars(seed=4)
    cprefix = jtf._write_tf1_checkpoint(tf, cv, str(tmp_path / "cls" / "model-150.ckpt"))
    cli.main(["--project_dir", d, "--model", "classifier", "--reference_ckpt", cprefix,
              "--train_folder", "log/cls"])
    assert "imported classifier epoch 150" in capsys.readouterr().out
    cls = ClassifierTrainer(num_classes=jtf.N_CLS, device="cpu").restore(
        osp.join(d, "log/cls"), 150)
    xc = np.random.RandomState(3).rand(2, jtf.CLS_N_POINTS, 3).astype(np.float32)
    with torch.no_grad():
        logits = cls._logits(torch.from_numpy(xc)).numpy()
    np.testing.assert_allclose(logits, jtf.numpy_classifier_forward(cv, xc),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_imported_tf_victim_attack_replays_the_golden(tmp_path, monkeypatch):
    """tests/test_import_tf.py:548-620 through the port's stages: the
    reference-format victim imported by the port, tst_ae,
    prepare_indices_for_attack and run_attack (with JAX's init_pert draw
    injected) on the CPU, against the JAX run's golden metrics."""
    tf = pytest.importorskip("tensorflow")
    from geometric_adv_tpu.attack.core import init_pert as jax_init_pert
    from geometric_adv_tpu_torch.attack import core as port_core
    from geometric_adv_tpu_torch.cli import (
        make_synthetic_data,
        prepare_indices_for_attack,
        run_attack,
        tst_ae,
    )
    from geometric_adv_tpu_torch.train.config import Configuration

    golden = osp.join(REPO, "tests", "golden", "adversarial_metrics_imported_tf_sphere.npy")
    if not osp.exists(golden):
        pytest.skip("no golden checked in")
    monkeypatch.setattr(port_core, "init_pert", lambda shape, device, stddev=1e-7, seed=55:
                        torch.tensor(np.asarray(jax_init_pert(shape, stddev, seed))).to(device))
    n_pts, enc, dec = 64, (8, 12, 6), (10, 64 * 3)
    v = jtf.make_ref_vars(seed=17, enc=enc, dec=dec)
    prefix = jtf._write_tf1_checkpoint(tf, v, str(tmp_path / "ref" / "models.ckpt-500"))
    d = str(tmp_path)
    ae = "log/imported_victim"
    train_dir = osp.join(d, ae)
    conf = Configuration(n_input=[n_pts, 3], bneck_size=enc[-1], encoder_filters=list(enc),
                         decoder_sizes=list(dec[:-1]), batch_size=8, train_dir=train_dir,
                         saver_step=None, class_names=["sphere", "cube", "torus"])
    path, epoch = import_tf.import_reference_checkpoint(prefix, train_dir, conf=conf)
    assert epoch == 500
    conf.save(osp.join(train_dir, "configuration"))
    c = ["--project_dir", d, "--device", "cpu"]
    make_synthetic_data.main(["--project_dir", d, "--data_folder", "data/tiny",
                              "--class_names", "sphere", "cube", "torus",
                              "--n_per_class", "40", "--n_points", str(n_pts)])
    tst_ae.main(c + ["--data_folder", "data/tiny", "--train_folder", ae,
                     "--restore_epoch", "500"])
    prepare_indices_for_attack.main(c + [
        "--ae_folder", ae, "--get_rand_idx", "1", "--get_latent_nn_idx", "1",
        "--get_chamfer_nn_idx", "1", "--num_instance_per_class", "4"])
    run_attack.main(c + ["--ae_folder", ae, "--attack_pc_idx",
                         f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy",
                         "--num_pc_for_attack", "2", "--num_pc_for_target", "2",
                         "--num_iterations", "5", "--num_iterations_thresh", "3",
                         "--use_mesh", "0"])
    m = np.load(osp.join(train_dir, "eval", "attack_res", "sphere",
                         "adversarial_metrics.npy"))
    np.testing.assert_allclose(m, np.load(golden), rtol=2e-4, atol=1e-6)
