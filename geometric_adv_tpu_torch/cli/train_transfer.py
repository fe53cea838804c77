"""Train a transfer autoencoder on the dataset's train split
(``geometric_adv_tpu/cli/train_transfer.py``; reference:
transfer/atlasnet/train.py via runner_atlasnet.sh --custom_data,
transfer/train_foldingnet.py), with a held-out eval on the val split every
``--val_step`` epochs. Records the architecture in ``arch.json`` beside the
checkpoint."""

import argparse
import os.path as osp

from geometric_adv_tpu_torch.cli.common import add_device_flag, ensure_dir, resolve_device
from geometric_adv_tpu_torch.data.augment import sort_axes
from geometric_adv_tpu_torch.data.datasets import load_dataset
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.transfer import get_transfer_ae, save_transfer_arch


def main(argv=None):
    """-> the trainer's [(epoch, loss, seconds)]."""
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--ae_type", type=str, default="atlasnet",
        choices=["atlasnet", "foldingnet"],
    )
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--bn_momentum", type=float, default=0.9)
    parser.add_argument("--number_points", type=int, default=2500)
    parser.add_argument("--nb_primitives", type=int, default=1)
    parser.add_argument("--template_type", type=str, default="SPHERE")
    parser.add_argument("--train_folder", type=str, default=None)
    parser.add_argument(
        "--val_step", type=int, default=1,
        help="epochs between held-out evals; 0 disables",
    )
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--data_folder", type=str, default="data/synthetic_2048")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Train transfer flags:", flags)
    device = resolve_device(flags.device)

    conf = Configuration.load(
        osp.join(flags.project_dir, flags.ae_folder, "configuration")
    )
    train_folder = flags.train_folder or f"log/{flags.ae_type}_for_transfer"
    train_dir = ensure_dir(osp.join(flags.project_dir, train_folder))
    top_in_dir = osp.join(flags.project_dir, flags.data_folder)

    pcs, _, _ = load_dataset(conf.class_names, "train_set", top_in_dir)
    pcs = sort_axes(pcs) if conf.sort_axes else pcs
    # per-epoch validation eval, like both reference transfer trainers
    # (reference: transfer/foldingnet/train_foldingnet.py:129-171,
    # transfer/atlasnet/training/trainer.py:83-110)
    val_pcs = None
    if flags.val_step > 0:
        val_pcs, _, _ = load_dataset(conf.class_names, "val_set", top_in_dir)
        val_pcs = sort_axes(val_pcs) if conf.sort_axes else val_pcs

    kwargs = dict(bn_momentum=flags.bn_momentum, device=device)
    if flags.learning_rate is not None:
        kwargs["learning_rate"] = flags.learning_rate
    arch = {}
    if flags.ae_type == "atlasnet":
        arch = dict(
            number_points=flags.number_points,
            nb_primitives=flags.nb_primitives,
            template_type=flags.template_type,
        )
    trainer = get_transfer_ae(flags.ae_type, **kwargs, **arch)
    # the inference CLIs (tst/run_transfer, run_metro) rebuild the module
    # from the checkpoint's folder alone
    save_transfer_arch(train_dir, flags.ae_type, **arch)
    with open(osp.join(train_dir, "train_stats.txt"), "a", 1) as log:
        stats = trainer.train(
            pcs, epochs=flags.epochs, batch_size=flags.batch_size,
            log_file=log, tag=flags.ae_type,
            held_out=val_pcs, val_step=max(flags.val_step, 1),
        )
    trainer.save(train_dir)
    print("saved checkpoint to", train_dir)
    return stats


if __name__ == "__main__":
    main()
