"""LM models of the PyTorch port: all six families, full-sequence forward,
prefill, loss and train steps, and decode.

  common -- norms, RoPE, attention / MLP parameters, full-sequence self-
            and cross-attention (direct, or blockwise past 1,024
            queries), one-token steps, cross-attention over precomputed
            K/V, embedding and unembedding
  moe    -- the top-k mixture-of-experts FFN (routing with per-group
            capacity, each routed expert on its rows) and the auxiliary
            load-balance loss
  ssm    -- Mamba2 parameters, the chunked SSD forward, its float32 cache
            and one-token step
  lm     -- the ``LM`` module of every family, ``init_params``,
            ``params_from_jax``, ``forward_hidden``, ``forward``,
            ``prefill``, ``lm_loss``, ``train_step``,
            ``train_step_accum``, ``Cache``, ``precompute_cross_kv``,
            ``decode_step`` and ``serve_step``
"""
