"""Geometry ops: Chamfer / nn_distance and the all-pairs chamfer matrix."""
