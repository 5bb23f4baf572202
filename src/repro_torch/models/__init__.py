"""LM models of the PyTorch port: the dense family's decode path.

  common -- norms, RoPE, attention / MLP parameters and one-token steps,
            embedding and unembedding
  lm     -- the ``LM`` module, ``init_params``, ``params_from_jax``,
            ``Cache``, ``decode_step`` and ``serve_step``
"""
