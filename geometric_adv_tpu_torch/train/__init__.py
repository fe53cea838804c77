"""Configuration, checkpoints and the inference half of the AE trainer."""
