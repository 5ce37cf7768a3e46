"""SEED-X on PyTorch and CUDA: the port of ``seedx_tpu`` to an NVIDIA H100.

Mirrors ``seedx_tpu``'s module paths and names so each module's counterpart
is easy to find.  Plain tensor code is PyTorch; the two kernels of the
image-in comprehension turn (flash-attention forward, W4A8 int4 matmul) are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use.

The host-side pieces the turn needs (vocabulary, byte tokenizer, prompts,
anyres tiling, the CLIP transform) are copies of ``seedx_tpu``'s pure-Python
modules under ``text/`` and ``data/``, so this package imports nothing of
``jax``, ``flax`` or the JAX package ``seedx_tpu``.
"""

__version__ = "0.1.0"
