"""PyTorch/CUDA port of the federated RNN-T system (``repro`` is the JAX
reference). It imports torch and numpy, never jax or ``repro``."""
