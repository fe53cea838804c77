"""The geometric adversarial attack (exact mode)."""
