"""State carried across from the JAX package."""
