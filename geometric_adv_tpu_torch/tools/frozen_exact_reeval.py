"""Exact re-measurement of the frozen attack's saved clouds against the
exact attack's, on the same source/target pairs
(``tools/frozen_exact_reeval.py``).

The frozen attack records metrics that majorize their true values
(PARITY.md #13), so a comparison of recorded metrics is an upper bound.
This recomputes, for a random sample of pairs of each class, the exact
chamfer S-CD(adversarial input, source) and T-RE(reconstruction, target)
from the saved ``adversarial_pc_input`` / ``adversarial_pc_recon`` of both
runs, with ``ops/chamfer.py::chamfer_loss_per_pc`` on ``--device``.

    python3 -m geometric_adv_tpu_torch.tools.frozen_exact_reeval \\
        --attack_pc_idx log/autoencoder_victim/eval/sel_idx_rand_25_test_set_13l.npy \\
        [--project_dir .] [--ae_folder log/autoencoder_victim] \\
        [--num_pc_for_attack 25] [--classes sphere cone] \\
        [--frozen_folder attack_res_frozen10] [--device cuda]

The pairs are those of the tool it ports: up to 192 a class, drawn from
``RandomState(0)``, re-measured 32 at a time.
"""

import argparse
import os.path as osp

import numpy as np
import torch

from geometric_adv_tpu_torch.cli.common import (
    NN_IDX_DICT,
    AttackContext,
    add_device_flag,
    resolve_device,
)
from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
from geometric_adv_tpu_torch.utils.artifacts import load_data

EXACT_FOLDER = "attack_res"
N_SAMPLE = 192
BATCH = 32
SEED = 0


def reeval(ctx, classes, runs, device):
    """Rows ``(class, run, S-CD, T-RE, Score)``: means over the same
    ``N_SAMPLE`` pairs of each class (all of them where it has fewer),
    drawn once per class from ``RandomState(SEED)``, for each run folder."""
    rng = np.random.RandomState(SEED)
    rows = []
    for cls in classes:
        src, tgt = ctx.class_attack_data(cls, ctx.point_clouds)
        idx = rng.choice(len(src), min(N_SAMPLE, len(src)), replace=False)
        for run in runs:
            d = osp.join(ctx.data_path, run, cls)
            adv = np.load(osp.join(d, "adversarial_pc_input.npy"))[0]
            rec = np.load(osp.join(d, "adversarial_pc_recon.npy"))[0]
            scd = np.zeros(len(idx))
            tre = np.zeros(len(idx))
            for k in range(0, len(idx), BATCH):
                j = idx[k:k + BATCH]
                with torch.no_grad():
                    scd[k:k + BATCH] = chamfer_loss_per_pc(
                        torch.from_numpy(adv[j]).to(device),
                        torch.from_numpy(src[j]).to(device)).cpu().numpy()
                    tre[k:k + BATCH] = chamfer_loss_per_pc(
                        torch.from_numpy(rec[j]).to(device),
                        torch.from_numpy(tgt[j]).to(device)).cpu().numpy()
            rows.append((cls, run, scd.mean(), tre.mean(), (scd + tre).mean()))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True,
                        help="the selection file, relative to --project_dir")
    parser.add_argument("--num_pc_for_attack", type=int, default=25)
    parser.add_argument("--classes", type=str, nargs="+",
                        default=["sphere", "cone"])
    parser.add_argument("--frozen_folder", type=str, default="attack_res_frozen10")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    ctx = AttackContext(flags.project_dir, flags.ae_folder,
                        attack_folder=EXACT_FOLDER,
                        attack_pc_idx=flags.attack_pc_idx,
                        num_pc_for_attack=flags.num_pc_for_attack)
    ctx.nn_idx = load_data(ctx.data_path, ctx.files,
                           [NN_IDX_DICT[ctx.conf.target_pc_idx_type]])
    runs = (EXACT_FOLDER, flags.frozen_folder)
    rows = reeval(ctx, flags.classes, runs, device)

    print(f"{'class':>8} {'run':>22} {'S-CD':>10} {'T-RE':>10} {'Score':>10}")
    for cls, run, s, t, sc in rows:
        print(f"{cls:>8} {run:>22} {s:.6f}  {t:.6f}  {sc:.6f}")
    for cls in flags.classes:
        r = {run: (s, t, sc) for c, run, s, t, sc in rows if c == cls}
        e, f = r[runs[0]], r[runs[1]]
        print(f"{cls}: frozen/exact exact-measured ratios "
              f"S-CD {f[0]/e[0]:.3f}  T-RE {f[1]/e[1]:.3f}  Score {f[2]/e[2]:.3f}")


if __name__ == "__main__":
    main()
