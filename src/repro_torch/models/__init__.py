"""LM models of the PyTorch port: the decode path of all six families.

  common -- norms, RoPE, attention / MLP parameters and one-token steps,
            cross-attention over precomputed K/V, embedding and
            unembedding
  moe    -- the top-k mixture-of-experts FFN (routing with per-group
            capacity, each routed expert on its rows)
  ssm    -- Mamba2 parameters, its float32 cache and one-token step
  lm     -- the ``LM`` module of every family, ``init_params``,
            ``params_from_jax``, ``Cache``, ``precompute_cross_kv``,
            ``decode_step`` and ``serve_step``
"""
