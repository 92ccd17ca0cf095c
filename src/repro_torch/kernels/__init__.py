"""Hand-written Hopper kernels, each beside its plain PyTorch version.

`ops.bcsr_spmm` and `ops.fused_gcn_layer` are the public entry points.
Importing this package builds nothing: the kernel library is compiled at
its first launch.
"""
