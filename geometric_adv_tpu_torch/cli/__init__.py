"""Pipeline stage CLIs of the port — same flags and artifacts as the JAX
package's, plus ``--device`` (default ``cuda``) on every stage that uses the
card:

    make_synthetic_data         the synthetic PLY dataset
    train_ae                    train the victim autoencoder
    tst_ae                      dump eval artifacts
    prepare_indices_for_attack  random/latent-NN/chamfer-NN indices
    run_attack                  the adversarial attack
    get_dists_per_point         per-adv-point source distances
    evaluate_attack             attack analysis + eval_stats (+ plots)
    run_defense_critical        the critical-points defense
    get_knn_dists_per_point     kNN distances for the off-surface defense
    run_defense_surface         the off-surface defense
    evaluate_defense            defense eval_stats

Run a stage as ``python -m geometric_adv_tpu_torch.cli.<stage> [flags]``.
"""
