"""Plain float32 references of models the port runs that the JAX package lacks:
each imports nothing but ``torch``."""
