"""Attack pair assembly and index preparation (host-side numpy) — a copy
of ``geometric_adv_tpu/attack/pipeline.py``.

The JAX package's ``geometric_adv_tpu.attack`` imports jax from its
``__init__``, so the port keeps its own copy of these exact ports of the
reference's selection logic (pinned to the original by
``tests/test_torch_imports.py``):

- ``prepare_data_for_attack`` (reference: src/adversary_utils.py:26-85);
- ``get_rand_idx`` (reference: attacker/prepare_indices_for_attack.py:70-86);
- ``sort_dist_mat`` (reference: prepare_indices_for_attack.py:167-180);
- ``latent_dist_matrix`` and the evaluation-side selection helpers.
"""

from __future__ import annotations

import numpy as np


def prepare_data_for_attack(
    pc_classes,
    source_classes_for_attack,
    target_classes_for_attack,
    classes_data,
    slice_idx,
    attack_pc_idx,
    num_pc_for_target,
    nn_idx_mat,
    correct_pred=None,
):
    """Build the flattened (source, target) pair rows for the attack grid.

    reference: src/adversary_utils.py:26-85.
    """
    num_classes = len(pc_classes)
    source_data_list = []
    target_data_list = []

    for i in range(num_classes):
        source_class_name = pc_classes[i]
        if source_class_name not in source_classes_for_attack:
            continue

        source_attack_idx = attack_pc_idx[i]
        num_source_pc_for_attack = len(source_attack_idx)

        source_class_data = classes_data[slice_idx[i]:slice_idx[i + 1]]
        source_class_data_for_attack = source_class_data[source_attack_idx]

        num_attack_per_pc = 0
        target_data_for_attack_list = []

        for j in range(num_classes):
            target_class_name = pc_classes[j]
            if (
                target_class_name not in target_classes_for_attack
                or target_class_name == source_class_name
            ):
                continue

            nn_idx_s_t = nn_idx_mat[
                slice_idx[i]:slice_idx[i + 1], slice_idx[j]:slice_idx[j + 1]
            ]
            assert nn_idx_s_t.shape[1] >= num_pc_for_target, (
                f"target class {target_class_name!r} has only "
                f"{nn_idx_s_t.shape[1]} examples but num_pc_for_target="
                f"{num_pc_for_target}; use a larger dataset or fewer targets"
            )
            nn_idx_for_attack = nn_idx_s_t[source_attack_idx].copy()
            if correct_pred is not None:
                nn_idx_for_attack = get_idx_for_correct_pred(
                    nn_idx_for_attack, correct_pred, slice_idx, j
                )

            num_attack_per_pc += num_pc_for_target

            target_class_data = classes_data[slice_idx[j]:slice_idx[j + 1]]
            per_source = []
            for s in range(num_source_pc_for_attack):
                target_attack_idx = nn_idx_for_attack[s, :num_pc_for_target]
                per_source.append(
                    np.expand_dims(target_class_data[target_attack_idx], 0)
                )
            target_data_for_attack_list.append(np.vstack(per_source))

        target_concat = np.concatenate(target_data_for_attack_list, axis=1)
        old_shape = target_concat.shape
        target_data_list.append(
            target_concat.reshape(
                [old_shape[0] * old_shape[1]] + list(old_shape[2:])
            )
        )
        source_data_list.append(
            np.vstack(
                [
                    [source_class_data_for_attack[s]] * num_attack_per_pc
                    for s in range(num_source_pc_for_attack)
                ]
            )
        )

    return np.vstack(source_data_list), np.vstack(target_data_list)


def get_idx_for_correct_pred(
    nn_idx_for_attack, correct_pred, slice_idx, t_class_index
):
    """Keep only targets the classifier predicts correctly
    (reference: src/adversary_utils.py:88-98)."""
    correct_t = correct_pred[
        slice_idx[t_class_index]:slice_idx[t_class_index + 1]
    ]
    correct_t_idx = np.where(correct_t)[0]
    for row in range(len(nn_idx_for_attack)):
        nn_idx_s = nn_idx_for_attack[row]
        kept = np.array(
            [idx for idx in nn_idx_s if idx in correct_t_idx],
            dtype=nn_idx_s.dtype,
        )
        nn_idx_for_attack[row, : len(kept)] = kept
        nn_idx_for_attack[row, len(kept):] = kept[0]
    return nn_idx_for_attack


def get_rand_idx(slice_idx, num_instance_per_class, seed=55):
    """Per-class random selection, seed re-set per class
    (reference: attacker/prepare_indices_for_attack.py:70-86)."""
    num_classes = len(slice_idx) - 1
    sel_idx = -1 * np.ones(
        [num_classes, num_instance_per_class], dtype=np.int16
    )
    for i in range(num_classes):
        np.random.seed(seed)
        num_examples = slice_idx[i + 1] - slice_idx[i]
        perm = np.arange(num_examples)
        np.random.shuffle(perm)
        num_instances = min(num_instance_per_class, num_examples)
        sel_idx[i, :num_instances] = perm[:num_instance_per_class]
    return sel_idx


def latent_dist_matrix(latent_vectors: np.ndarray) -> np.ndarray:
    """Dense pairwise L2 matrix of latent codes
    (reference: src/general_utils.py:94-106)."""
    diff = latent_vectors[:, None, :] - latent_vectors[None, :, :]
    return np.linalg.norm(diff, axis=-1)


def sort_dist_mat(dist_mat, slice_idx):
    """Per class-pair ascending argsort, local indices
    (reference: attacker/prepare_indices_for_attack.py:167-180)."""
    nn_idx = -1 * np.ones(dist_mat.shape, dtype=np.int16)
    num_classes = len(slice_idx) - 1
    for i in range(num_classes):
        for j in range(num_classes):
            block = dist_mat[
                slice_idx[i]:slice_idx[i + 1], slice_idx[j]:slice_idx[j + 1]
            ]
            nn_idx[
                slice_idx[i]:slice_idx[i + 1], slice_idx[j]:slice_idx[j + 1]
            ] = np.argsort(block, axis=1).astype(np.int16)
    assert nn_idx.min() >= 0, "the nn_idx matrix was not filled correctly"
    return nn_idx


# --- evaluation-side selection helpers (reference: src/adversary_utils.py:
#     101-146), shared by evaluate_attack / defense / transfer / classifier.
def get_quantity_at_index(quantity_list, index):
    out = [
        np.zeros(q.shape[1:], dtype=q.dtype) for q in quantity_list
    ]
    for i, quantity in enumerate(quantity_list):
        for j in range(len(index)):
            out[i][j] = quantity[index[j], j]
    return out[0] if len(out) == 1 else out


def get_quantity_at_index_per_target_class(quantity, per_target_class_idx):
    num_instance, num_target_classes = per_target_class_idx.shape
    out = np.zeros([num_instance, num_target_classes], dtype=quantity.dtype)
    num_pc_for_target = quantity.shape[1] // per_target_class_idx.shape[1]
    for k in range(num_target_classes):
        q_k = quantity[:, k * num_pc_for_target:(k + 1) * num_pc_for_target]
        out[:, k] = get_quantity_at_index(
            [q_k.T], per_target_class_idx[:, k]
        )
    return out


def get_quantity_for_targeted_untargeted_attack(
    quantity, dist_weight_idx, targeted_idx, untargeted_idx
):
    """reference: src/adversary_utils.py:126-146."""
    num_attacks = quantity.shape[1]
    num_instance, num_target_classes = targeted_idx.shape
    num_attack_per_instance = num_attacks // num_instance
    num_pc_for_target = num_attack_per_instance // num_target_classes

    q_dw = get_quantity_at_index([quantity], dist_weight_idx)
    q_dw = q_dw.reshape([num_instance, num_attack_per_instance])

    q_targeted = get_quantity_at_index_per_target_class(q_dw, targeted_idx)

    q_untargeted = np.zeros(num_instance, dtype=q_targeted.dtype)
    for j in range(num_instance):
        c_idx = untargeted_idx[j]
        best_t_idx = targeted_idx[j, c_idx]
        q_untargeted[j] = q_dw[j, c_idx * num_pc_for_target + best_t_idx]
    return q_dw, q_targeted, q_untargeted
