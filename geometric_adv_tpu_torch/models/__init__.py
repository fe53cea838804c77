"""The victim PointNet autoencoder and the weight bridge from the JAX package."""
