"""The ``.npy`` artifact store, the eval_stats writers and the report plots
(copies of ``geometric_adv_tpu.utils``' modules that need no JAX, pinned by
tests), and the device traces."""
