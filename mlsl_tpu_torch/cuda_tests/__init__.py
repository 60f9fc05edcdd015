"""The port's tests that need the card: each CUDA kernel against its plain
PyTorch version. They import only torch, numpy, pytest and the port, so they
run where JAX is not installed:

    python -m pytest mlsl_tpu_torch/cuda_tests -q -p no:cacheprovider

``chip_smoke.py`` runs them as one of its phases; without a card every test
skips.
"""
