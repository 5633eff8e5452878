"""Test utilities shared with the JAX package's conventions."""
