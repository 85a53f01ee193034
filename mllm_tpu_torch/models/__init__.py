"""Model definitions, checkpoint loading and the JAX parameter bridge."""
