"""Hand-written Hopper kernels, each beside its plain PyTorch version.

`ops.bcsr_spmm` is the public entry point. Importing this package builds
nothing: a kernel's library is compiled at its first launch.
"""
