"""Hand-written Hopper kernels, each beside its plain PyTorch version.

`ops.bcsr_spmm`, `ops.fused_gcn_layer`, `ops.flash_attention` and
`ops.decode_attention` are the public entry points. Importing this package
builds nothing: `kernels.build` compiles the one library of every kernel at
the first launch.
"""
