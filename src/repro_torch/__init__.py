"""PyTorch/CUDA port of the Ape-X reproduction in ``repro``.

Same subpackage layout and module names as the JAX package; the kernels
that the JAX package writes in Pallas for the TPU are written by hand for
Hopper here (``kernels/``, with CUDA sources in ``csrc/``). Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
