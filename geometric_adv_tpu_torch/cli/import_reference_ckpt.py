"""Import a reference pretrained model checkpoint (and optionally its
config) into the port's experiment layout
(``geometric_adv_tpu/cli/import_reference_ckpt.py``).

The reference ships pretrained models (download_models_and_data.sh) as TF1
``tf.train.Saver`` checkpoints (victim/transfer AEs ``models.ckpt-500``,
classifier ``model-150.ckpt``) and torch state dicts (AtlasNet
``network.pth``, FoldingNet ``checkpoint_<epoch>.pth``). This driver writes
any of them as the port's checkpoint, so every later stage restores it with
its ``--*restore_epoch`` flag as if it had been trained here:

    python -m geometric_adv_tpu_torch.cli.import_reference_ckpt \
        --reference_ckpt ref_log/autoencoder_victim/models.ckpt-500 \
        --reference_config ref_log/autoencoder_victim/configuration.txt \
        --train_folder log/autoencoder_victim

    python -m geometric_adv_tpu_torch.cli.import_reference_ckpt --model atlasnet \
        --reference_ckpt ref_log/atlasnet_for_transfer/network.pth \
        --train_folder log/atlasnet_for_transfer

TF models (``--model ae|classifier``) need the `tensorflow` package for its
checkpoint reader; torch models import anywhere. The stage computes on the
host (no ``--device``). Mappings: train/import_tf.py, train/import_torch.py.
"""

import argparse
import os.path as osp

from geometric_adv_tpu_torch.cli.common import ensure_dir
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.train.import_tf import (
    import_reference_checkpoint,
    import_reference_classifier_checkpoint,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--reference_ckpt", type=str, required=True,
        help="saver prefix, e.g. .../models.ckpt-500 or .../model-150.ckpt "
        "(not the .index file)",
    )
    parser.add_argument(
        "--model", type=str, default="ae",
        choices=["ae", "classifier", "atlasnet", "foldingnet"],
        help="ae: PointNet autoencoder (victim / PointNet-transfer, TF); "
        "classifier: the PointNet classifier (model-<epoch>.ckpt, TF); "
        "atlasnet / foldingnet: the torch transfer AEs (network.pth / "
        "checkpoint_<epoch>.pth)",
    )
    parser.add_argument(
        "--reference_config", type=str, default=None,
        help="the reference experiment's configuration.txt dump; when given, "
        "a configuration.json/.txt pair is written to the train folder and "
        "the imported weights are shape-checked against the architecture",
    )
    parser.add_argument(
        "--train_folder", type=str, default="log/autoencoder_victim"
    )
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument(
        "--ae_name", type=str, default=None,
        help="reference model scope; default: auto-detected from the "
        "checkpoint's variable names",
    )
    parser.add_argument(
        "--epoch", type=int, default=None,
        help="default: the saver-prefix suffix, else the epoch variable",
    )
    flags = parser.parse_args(argv)
    print("Import reference checkpoint flags:", flags)

    if flags.model in ("ae", "classifier") and (
        flags.reference_ckpt.endswith((".index", ".meta"))
        or ".data-" in flags.reference_ckpt
    ):
        raise SystemExit(
            "--reference_ckpt must be the saver PREFIX (strip the "
            ".index/.data-*/.meta suffix)"
        )

    train_dir = ensure_dir(osp.join(flags.project_dir, flags.train_folder))

    if flags.model in ("atlasnet", "foldingnet"):
        if flags.reference_config is not None:
            raise SystemExit(
                "--reference_config applies to --model ae only"
            )
        from geometric_adv_tpu_torch.train.import_torch import (
            import_reference_atlasnet_checkpoint,
            import_reference_foldingnet_checkpoint,
        )

        if flags.model == "atlasnet":
            path, epoch, meta = import_reference_atlasnet_checkpoint(
                flags.reference_ckpt, train_dir, epoch=flags.epoch or 0
            )
            print(f"imported atlasnet epoch {epoch} ({meta}) -> {path}")
            if (meta["nb_primitives"], meta["template_dim"]) != (1, 3):
                print(
                    "NOTE: non-default architecture — build the trainer "
                    f"with nb_primitives={meta['nb_primitives']}, "
                    "template_type="
                    f"{'SPHERE' if meta['template_dim'] == 3 else 'SQUARE'}"
                )
        else:
            path, epoch = import_reference_foldingnet_checkpoint(
                flags.reference_ckpt, train_dir, epoch=flags.epoch
            )
            print(f"imported foldingnet epoch {epoch} -> {path}")
        print(
            "restore with: --transfer_ae_folder "
            f"{flags.train_folder} --transfer_ae_restore_epoch {epoch}"
        )
        return

    if flags.model == "classifier":
        if flags.reference_config is not None:
            raise SystemExit(
                "--reference_config applies to --model ae only (the "
                "reference classifier has no Configuration object)"
            )
        path, epoch, num_classes, use_tnets = (
            import_reference_classifier_checkpoint(
                flags.reference_ckpt, train_dir, epoch=flags.epoch
            )
        )
        print(
            f"imported classifier epoch {epoch} ({num_classes} classes, "
            f"{'full' if use_tnets else 'basic'} model) -> {path}"
        )
        print(
            "restore with: --classifier_folder "
            f"{flags.train_folder} --classifier_restore_epoch {epoch}"
        )
        return

    conf = None
    if flags.reference_config is not None:
        conf = Configuration.from_reference_txt(flags.reference_config)
        conf.train_dir = train_dir
        conf.save(osp.join(train_dir, "configuration"))
        print(f"wrote {osp.join(train_dir, 'configuration')}.json/.txt")

    path, epoch = import_reference_checkpoint(
        flags.reference_ckpt,
        train_dir,
        ae_name=flags.ae_name,
        epoch=flags.epoch,
        conf=conf,
    )
    print(f"imported epoch {epoch} -> {path}")
    print(
        "restore with: --train_folder "
        f"{flags.train_folder} --restore_epoch {epoch}"
    )


if __name__ == "__main__":
    main()
