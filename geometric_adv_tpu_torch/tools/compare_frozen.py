"""Compares the frozen-assignment attack with the exact one on the same
pair grid (``tools/compare_frozen.py``): per-pair metric differences over
every class both attack folders hold, then both runs' over-classes
``eval_stats.txt`` side by side. Host only: it reads ``.npy`` artifacts.

    python3 -m geometric_adv_tpu_torch.tools.compare_frozen \\
        [--project_dir .] [--ae_folder log/autoencoder_victim] \\
        [--frozen_folder attack_res_frozen10]

The exact attack's folder is ``attack_res``, as in the tool it ports.
"""

import argparse
import glob
import os.path as osp

import numpy as np

COLS = ["loss_adv", "loss_dist", "S-CD", "T-NRE", "T-RE"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--frozen_folder", type=str, default="attack_res_frozen10")
    flags = parser.parse_args(argv)

    base = osp.join(flags.project_dir, flags.ae_folder, "eval")
    exact_dir = osp.join(base, "attack_res")
    frozen_dir = osp.join(base, flags.frozen_folder)
    all_e, all_f = [], []
    for cls_dir in sorted(glob.glob(osp.join(exact_dir, "*"))):
        cls = osp.basename(cls_dir)
        fe = osp.join(cls_dir, "adversarial_metrics.npy")
        ff = osp.join(frozen_dir, cls, "adversarial_metrics.npy")
        if not (osp.exists(fe) and osp.exists(ff)):
            continue
        all_e.append(np.load(fe))
        all_f.append(np.load(ff))
    if not all_e:
        raise SystemExit(f"no class holds adversarial_metrics.npy in both "
                         f"{exact_dir} and {frozen_dir}")
    e = np.concatenate([a.reshape(-1, a.shape[-1]) for a in all_e])
    f = np.concatenate([a.reshape(-1, a.shape[-1]) for a in all_f])
    print(f"pairs compared: {len(e)} over {len(all_e)} classes")
    for c in range(e.shape[1]):
        d = np.abs(e[:, c] - f[:, c])
        scale = np.maximum(np.abs(e[:, c]), 1e-9)
        print(
            f"{COLS[c]:>9}: exact mean {e[:, c].mean():.6f}  frozen mean "
            f"{f[:, c].mean():.6f}  max|d| {d.max():.2e}  max rel "
            f"{(d / scale).max():.2e}  mean rel {(d / scale).mean():.2e}"
        )
    for name, dd in (("exact", exact_dir), ("frozen", frozen_dir)):
        p = osp.join(dd, "over_classes", "eval_stats.txt")
        if osp.exists(p):
            print(f"--- {name} over_classes eval_stats.txt ---")
            with open(p) as fh:
                print(fh.read())


if __name__ == "__main__":
    main()
