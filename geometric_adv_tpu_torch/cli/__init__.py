"""Pipeline stage CLIs of the port — same flags and artifacts as the JAX
package's, plus ``--device`` (default ``cuda``):

    tst_ae                      dump eval artifacts
    prepare_indices_for_attack  random/latent-NN/chamfer-NN indices
    run_attack                  the adversarial attack
    get_dists_per_point         per-adv-point source distances
    evaluate_attack             attack analysis + eval_stats

Run a stage as ``python -m geometric_adv_tpu_torch.cli.<stage> [flags]``.
"""
