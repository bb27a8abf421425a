"""Configs, weight loading, and weight conversion from the JAX package."""
