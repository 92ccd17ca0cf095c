"""Hand-written Hopper kernels, each beside its plain PyTorch version.

`bcsr_spmm`, `fused_gcn_layer`, `decode_attention` and `flash_attention`
(from `ops`) are the public entry points, and `ref` holds the oracles, as
in `repro.kernels`. Importing this package builds nothing: `kernels.build`
compiles the one library of every kernel at the first launch.

The function `bcsr_spmm` shadows the submodule of the same name as an
attribute of this package, so `from repro_torch.kernels import bcsr_spmm`
and `import repro_torch.kernels.bcsr_spmm as m` both give the function.
Reach the module (its CUDA wrappers, launch counts and `build`) through
`importlib.import_module("repro_torch.kernels.bcsr_spmm")`.
"""
from repro_torch.kernels.ops import (
    bcsr_spmm,
    fused_gcn_layer,
    decode_attention,
    flash_attention,
)
from repro_torch.kernels import ref

__all__ = ["bcsr_spmm", "fused_gcn_layer", "decode_attention",
           "flash_attention", "ref"]
