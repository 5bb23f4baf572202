"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

  costmodel_eval -- batched cost evaluation: against one layer table, or
                    with a layer row per point (the search service's)
  lstm_cell      -- fused REINFORCE policy step, with its gradient
  flash_decode   -- one query token's GQA attention over a KV cache (the
                    LM decode step)

``ops`` exposes the shape-flexible wrappers, ``ref`` the plain PyTorch
versions, ``build`` compiles ``csrc/*.cu`` with nvcc on first use.
Importing this package builds nothing.
"""
