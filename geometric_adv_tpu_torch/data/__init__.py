"""Host-side data: PLY IO, dataset splits, axis sorting, synthetic shapes.

Copies of the numpy-only modules of ``geometric_adv_tpu.data`` (pinned to
them by ``tests/test_torch_imports.py``), so the port runs where the JAX
package cannot be imported.
"""
