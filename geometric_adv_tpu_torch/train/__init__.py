"""Configuration, checkpoints, the AE trainer and the reference-checkpoint
importers."""
