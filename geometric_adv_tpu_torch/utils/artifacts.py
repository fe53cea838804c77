"""The .npy artifact store — ``load_data`` copied from
``geometric_adv_tpu/utils/artifacts.py`` (pinned by
``tests/test_torch_imports.py``). Stages find artifacts by SUBSTRING match of
a base name against the directory listing (reference:
src/adversary_utils.py:13-23); names follow
``<base>_<set_type>_<object_class>.npy``.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np


def load_data(data_path: str, file_list=None, base_name_list=None):
    """Substring-match loader (reference: src/adversary_utils.py:13-23)."""
    if file_list is None:
        file_list = [
            f for f in os.listdir(data_path)
            if osp.isfile(osp.join(data_path, f))
        ]
    data_list = [None] * len(base_name_list)
    for i, base_name in enumerate(base_name_list):
        matches = [f for f in file_list if base_name in f]
        if not matches:
            raise FileNotFoundError(
                f"no artifact matching {base_name!r} under {data_path}"
            )
        data_list[i] = np.load(osp.join(data_path, matches[0]),
                               allow_pickle=False)
    if len(data_list) == 1:
        return data_list[0]
    return data_list
