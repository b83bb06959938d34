"""PyTorch/CUDA port of the JAX package ``repro``.

Each module at ``repro_torch/<path>`` ports ``repro/<path>``; the port imports
``torch`` and never JAX or ``repro``.
"""
