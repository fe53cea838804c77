"""The eval_stats writers of the attack, the defenses, transfer and the
classifier — copied from ``geometric_adv_tpu/utils/stats.py`` (byte format
of reference: src/adversary_utils.py:181-329), pinned by
``tests/test_torch_imports.py``.
"""

from __future__ import annotations

import numpy as np


def _pad(name: str) -> str:
    return name + " " * (16 - len(name))


def write_attack_statistics_to_file(
    fout, classes_for_attack, source_target_norm_min_list,
    num_outlier_list, source_chamfer_list, target_chamfer_list,
    target_nre_list,
):
    """reference: src/adversary_utils.py:181-219."""
    fout.write("Shape\t\tAttack\t\tAdv\t\tAdv\t\tAdv\t\tAdv\n")
    fout.write("Class\t\tScore\t\t#OS\t\tS-CD\t\tT-RE\t\tT-NRE\n")
    fout.write("\n")
    for c, name in enumerate(classes_for_attack):
        fout.write(
            "%s%.5f\t\t%03d\t\t%.5f\t\t%.5f\t\t%.2f\n"
            % (
                _pad(name),
                source_target_norm_min_list[c].mean(),
                int(num_outlier_list[c].mean() + 0.5),
                source_chamfer_list[c].mean(),
                target_chamfer_list[c].mean(),
                target_nre_list[c].mean(),
            )
        )
    fout.write("\n")
    fout.write(
        "%s%.5f\t\t%03d\t\t%.5f\t\t%.5f\t\t%.2f\n"
        % (
            _pad("over classes"),
            np.vstack(source_target_norm_min_list).mean(),
            int(np.vstack(num_outlier_list).mean() + 0.5),
            np.vstack(source_chamfer_list).mean(),
            np.vstack(target_chamfer_list).mean(),
            np.vstack(target_nre_list).mean(),
        )
    )


def write_defense_statistics_to_file(
    fout, classes_for_attack, def_source_chamfer_list, def_source_nre_list,
    adv_source_chamfer_list, adv_source_nre_list,
):
    """reference: src/adversary_utils.py:222-257."""
    fout.write("Shape\t\tDef\t\tDef\t\tAdv\t\tAdv\n")
    fout.write("Class\t\tS-RE\t\tS-NRE\t\tS-RE\t\tS-NRE\n")
    fout.write("\n")
    for c, name in enumerate(classes_for_attack):
        fout.write(
            "%s%.5f\t\t%.2f\t\t%.5f\t\t%.2f\n"
            % (
                _pad(name),
                def_source_chamfer_list[c].mean(),
                def_source_nre_list[c].mean(),
                adv_source_chamfer_list[c].mean(),
                adv_source_nre_list[c].mean(),
            )
        )
    fout.write("\n")
    fout.write(
        "%s%.5f\t\t%.2f\t\t%.5f\t\t%.2f\n"
        % (
            _pad("over classes"),
            np.vstack(def_source_chamfer_list).mean(),
            np.vstack(def_source_nre_list).mean(),
            np.vstack(adv_source_chamfer_list).mean(),
            np.vstack(adv_source_nre_list).mean(),
        )
    )


def write_transfer_statistics_to_file(
    fout, classes_for_attack, tra_target_chamfer_list, tra_target_nre_list,
    adv_target_chamfer_list, adv_target_nre_list,
):
    """reference: src/adversary_utils.py:260-295."""
    fout.write("Shape\t\tTra\t\tTra\t\tAdv\t\tAdv\n")
    fout.write("Class\t\tT-RE\t\tT-NRE\t\tT-RE\t\tT-NRE\n")
    fout.write("\n")
    for c, name in enumerate(classes_for_attack):
        fout.write(
            "%s%.5f\t\t%.2f\t\t%.5f\t\t%.2f\n"
            % (
                _pad(name),
                tra_target_chamfer_list[c].mean(),
                tra_target_nre_list[c].mean(),
                adv_target_chamfer_list[c].mean(),
                adv_target_nre_list[c].mean(),
            )
        )
    fout.write("\n")
    fout.write(
        "%s%.5f\t\t%.2f\t\t%.5f\t\t%.2f\n"
        % (
            _pad("over classes"),
            np.vstack(tra_target_chamfer_list).mean(),
            np.vstack(tra_target_nre_list).mean(),
            np.vstack(adv_target_chamfer_list).mean(),
            np.vstack(adv_target_nre_list).mean(),
        )
    )


def write_classification_statistics_to_file(
    fout, classes_for_attack, recon_cls_list, data_type
):
    """reference: src/adversary_utils.py:298-329."""
    headers = {
        "target": ("Orig target recon", "Target accuracy"),
        "adversarial": ("Adv recon", "Target accuracy"),
        "source": ("Orig source recon", "Source accuracy"),
        "before_defense": ("Adv recon", "Source accuracy"),
        "after_defense": ("Def recon", "Source accuracy"),
    }
    h1, h2 = headers[data_type]
    fout.write(f"Shape\t\t{h1}\n")
    fout.write(f"Shape\t\t{h2}\n")
    fout.write("\n")
    for c, name in enumerate(classes_for_attack):
        fout.write("%s%.4f\n" % (_pad(name), recon_cls_list[c].mean()))
    fout.write("\n")
    fout.write(
        "%s%.4f\n" % (_pad("over classes"), np.vstack(recon_cls_list).mean())
    )
