"""AIRES out-of-core GCN serving and training, and dense GQA LM serving,
on PyTorch and CUDA.

A port of the JAX package `repro`, which stays the reference: the same
host-side plans, bricks and byte accounting, with the TPU's Pallas kernels
replaced by hand-written CUDA kernels for Hopper (`repro_torch.kernels`).
Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`. This package imports neither `jax` nor `repro`.
"""
