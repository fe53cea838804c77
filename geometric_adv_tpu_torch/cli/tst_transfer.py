"""Evaluate a trained transfer AE on the clean test set
(``geometric_adv_tpu/cli/tst_transfer.py``; reference:
transfer/foldingnet/tst_foldingnet.py:1-98): reconstruct every cloud of the
victim's ``point_clouds_test_set`` with the restored transfer AE, report the
example-weighted mean chamfer loss (and FoldingNet's middle-fold loss), and
dump the recon/loss artifacts under ``<train_folder>/eval/`` with tst_ae's
names."""

import argparse
import os.path as osp

import numpy as np
import torch

from geometric_adv_tpu_torch.cli.common import (
    add_device_flag,
    ensure_dir,
    eval_dir,
    list_files,
    resolve_device,
)
from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.transfer import get_transfer_ae, load_transfer_arch
from geometric_adv_tpu_torch.utils.artifacts import load_data


def main(argv=None):
    """-> the trainer's ``evaluate`` dict."""
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--ae_type", type=str, default="foldingnet",
        choices=["atlasnet", "foldingnet"],
    )
    parser.add_argument("--train_folder", type=str, required=True)
    parser.add_argument("--restore_epoch", type=int, default=None)
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--set_type", type=str, default="test_set")
    parser.add_argument("--batch_size", type=int, default=100)
    parser.add_argument("--number_points", type=int, default=2500)
    parser.add_argument("--nb_primitives", type=int, default=1)
    parser.add_argument("--template_type", type=str, default="SPHERE")
    parser.add_argument("--project_dir", type=str, default=".")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Test transfer flags:", flags)
    device = resolve_device(flags.device)

    conf = Configuration.load(
        osp.join(flags.project_dir, flags.ae_folder, "configuration")
    )
    data_path = eval_dir(flags.project_dir, flags.ae_folder)
    point_clouds = load_data(
        data_path, list_files(data_path), [f"point_clouds_{flags.set_type}"]
    ).astype(np.float32)
    print(f"{flags.set_type}: {len(point_clouds)} examples")

    train_dir = osp.join(flags.project_dir, flags.train_folder)
    kwargs = dict(device=device)
    arch = load_transfer_arch(train_dir)
    if arch is not None:
        # the checkpoint's recorded architecture wins over the flags (a
        # mismatched module could not restore anyway)
        arch.pop("ae_type", None)
        kwargs.update(arch)
        if arch:
            print(f"transfer arch from {train_dir}/arch.json: {arch}")
    elif flags.ae_type == "atlasnet":
        kwargs.update(
            number_points=flags.number_points,
            nb_primitives=flags.nb_primitives,
            template_type=flags.template_type,
        )
    ae = get_transfer_ae(flags.ae_type, **kwargs)
    ae.restore(train_dir, flags.restore_epoch)
    print("Checkpoint successfully loaded")

    recon = ae.get_reconstructions(point_clouds, batch_size=flags.batch_size)
    with torch.no_grad():
        loss_per_pc = chamfer_loss_per_pc(
            torch.as_tensor(recon, device=device),
            torch.as_tensor(point_clouds, device=device)).cpu().numpy()
    ev = ae.evaluate(point_clouds, batch_size=flags.batch_size)

    out_dir = ensure_dir(osp.join(train_dir, "eval"))
    # the reference's free-form object-class tag, e.g. "_13l"
    # (reference: src/adversary_utils.py:13-23 substring lookup)
    suffix = "_" + "_".join(conf.object_class)
    np.save(
        osp.join(out_dir, f"reconstructions_{flags.set_type}{suffix}"), recon
    )
    np.save(
        osp.join(out_dir, f"ae_loss_{flags.set_type}{suffix}"), loss_per_pc
    )

    msg = f"Testing test loss: {ev['loss']:f}"
    if "mid_loss" in ev:
        msg += f" middle test loss: {ev['mid_loss']:f}"
    print(msg)
    with open(osp.join(out_dir, "test_stats.txt"), "a", 1) as f:
        f.write(msg + "\n")
    return ev


if __name__ == "__main__":
    main()
