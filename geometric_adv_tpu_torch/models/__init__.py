"""The victim PointNet autoencoder, its sparse encoder VJP, the classifier
and transfer AEs, and the weight bridge from the JAX package."""
