"""MAESTRO-style analytical cost model (hard path), in PyTorch.

Submodules mirror ``repro.costmodel``: ``layers`` (descriptors),
``dataflows`` (level tables, L1 formulas), ``primitives`` (hard plateau
ops), ``maestro`` (the model core) and ``workloads`` (the paper's DNNs).
"""
