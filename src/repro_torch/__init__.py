"""ConfuciuX in PyTorch + CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` module for module (``costmodel``,
``kernels``, ``core``, ``training``, ``api``, ``serving``, ``launch``) so
each counterpart is easy to find.  This package imports ``torch`` and never ``jax`` or ``repro``; its
entry points run on the CUDA card unless the caller asks for the CPU.
"""
