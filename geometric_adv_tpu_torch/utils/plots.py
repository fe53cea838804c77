"""Report plots — the two of ``geometric_adv_tpu/utils/plots.py`` that
``evaluate_attack`` draws (reference: src/general_utils.py:212-223,
attacker/evaluate_attack.py:289-327) and ``plot_3d_point_cloud``
(reference: src/general_utils.py:168-209), headless (Agg backend).

matplotlib, and pandas and seaborn for the heatmap, are imported inside the
plot functions, so the port imports where they are not installed; only a
plot call raises ImportError there.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_3d_point_cloud(
    pc, show=False, in_u_sphere=True, marker=".", s=8, alpha=0.8,
    figsize=(5, 5), elev=10, azim=240, axis=None, title=None, save_path=None,
):
    """reference: src/general_utils.py:168-209."""
    plt = _pyplot()
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    if axis is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111, projection="3d")
    else:
        ax = axis
        fig = axis
    if title is not None:
        plt.title(title)
    ax.scatter(x, y, z, marker=marker, s=s, alpha=alpha)
    ax.view_init(elev=elev, azim=azim)
    if in_u_sphere:
        ax.set_xlim3d(-0.5, 0.5)
        ax.set_ylim3d(-0.5, 0.5)
        ax.set_zlim3d(-0.5, 0.5)
    if save_path is not None:
        plt.savefig(save_path)
        plt.close(fig)
    elif show:
        plt.show()
    return fig


def plot_attack_triplet(source_pc, adv_pc, recon_pc, save_path, titles=None):
    """3-panel source / adversarial / reconstruction figure
    (reference: attacker/evaluate_attack.py:289-327)."""
    plt = _pyplot()
    titles = titles or ["source", "adversarial input", "adversarial recon"]
    fig = plt.figure(figsize=(15, 5))
    for k, (pc, title) in enumerate(zip([source_pc, adv_pc, recon_pc], titles)):
        ax = fig.add_subplot(1, 3, k + 1, projection="3d")
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], marker=".", s=8, alpha=0.8)
        ax.set_xlim3d(-0.5, 0.5)
        ax.set_ylim3d(-0.5, 0.5)
        ax.set_zlim3d(-0.5, 0.5)
        ax.view_init(elev=10, azim=240)
        ax.set_title(title)
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close(fig)


def plot_heatmap_graph(
    heatmap_vals, rows_label, columns_label, pc_class_name, xlabel, ylabel,
    fmt, save_path, figsize=(5, 5), font_size=16,
):
    """reference: src/general_utils.py:212-223."""
    plt = _pyplot()
    import pandas as pd
    import seaborn as sn

    plt.figure(figsize=figsize)
    df = pd.DataFrame(np.asarray(heatmap_vals), rows_label, columns_label)
    sn.set(font_scale=1.4)
    sn.heatmap(df, annot=True, fmt=fmt, annot_kws={"size": 10})
    plt.xlabel(xlabel, fontsize=font_size)
    plt.ylabel(ylabel, fontsize=font_size)
    plt.title("Shape Class $\\bf{%s}$" % pc_class_name, fontsize=font_size)
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close()
