"""Micro-probes of the card (≙ the JAX repo's probes/): small kernels that
time one primitive of a production kernel in isolation."""
