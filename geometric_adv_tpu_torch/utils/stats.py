"""The attack eval_stats writer — copied from
``geometric_adv_tpu/utils/stats.py`` (byte format of reference:
src/adversary_utils.py:181-219), pinned by ``tests/test_torch_imports.py``.
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
