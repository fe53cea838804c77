"""Pipeline stage CLIs of the port — same flags and artifacts as the JAX
package's, plus ``--device`` (default ``cuda``) on every stage that uses the
card and on the classifier's and transfer's evaluate stages:

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
    train_classifier            train the PointNet classifier (+ test-set labels)
    tst_classifier              classifier test-set accuracy
    run_classifier              classify reconstructions per data_type
    evaluate_classifier         semantic attack statistics
    train_transfer              train an AtlasNet or FoldingNet transfer AE
    tst_transfer                a transfer AE on the clean test set
    run_transfer                adversarial inputs through a transfer AE
    evaluate_transfer           transferability statistics
    run_metro                   metro (mesh Hausdorff) eval of AtlasNet

Run a stage as ``python -m geometric_adv_tpu_torch.cli.<stage> [flags]``.
"""
