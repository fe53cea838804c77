"""The ``.npy`` artifact store and the eval_stats writer (copies of
``geometric_adv_tpu.utils``' numpy-only modules, pinned by tests)."""
