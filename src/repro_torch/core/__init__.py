"""ConfuciuX core in PyTorch: the engines of the two-stage search.

  env        -- the interactive environment (cost model + constraints)
  policy     -- LSTM/MLP policy networks
  reinforce  -- stage-1 REINFORCE global search
  ga         -- stage-2 local GA fine-tuner + baseline GA
  baselines  -- random, grid, simulated annealing, Bayesian optimization
  search     -- two-stage orchestration + LS per-layer study
  chunk      -- the shared chunk loop

The user-facing entry point is :mod:`repro_torch.api`.
"""
