"""Collective traffic of a step, per device: from HLO text, as
`repro.launch.hlo_analysis` reads it, and from the FX graphs the torch dry
run captures (`launch.dryrun`).

HLO text (`collective_bytes`, `collective_count`): the result-shape bytes
of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, summed; async pairs (-start/-done) are counted once,
at the -start op. The regexes and the dtype table are the reference's.

FX graphs (`graph_collective_bytes`, `graph_collective_count`): the graphs
`torch.compile` captures of DTensor code after AOTAutograd has lowered it
to local shapes, each collective an explicit `_c10d_functional` call
followed by `wait_tensor`. These are the counterpart of the HLO after SPMD
partitioning: the bytes are each collective's per-device result, reported
under the reference's kind names, and `wait_tensor`, like -done, is not
counted.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, Tuple

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# `%name = <shape-or-tuple> <op>(` — shape like bf16[8,128]{1,0} or a tuple.
_OP_RE = re.compile(
    r"=\s*(\([^=]*?\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

# XLA:CPU's AllReducePromotion pass rewrites bf16/f16 all-reduces to
# convert→f32-all-reduce→convert (the reducer computation gets a
# "_promoted" suffix). XLA:TPU reduces bf16 natively, so for the TPU-target
# roofline those ops are counted at their pre-promotion width.
_PROMOTED_RE = re.compile(r"to_apply=%\S*promoted")


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str,
                     undo_cpu_promotion: bool = True
                     ) -> Tuple[int, Dict[str, int]]:
    """Total per-device collective bytes + per-op-kind breakdown."""
    by_kind: Dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        shape_text, kind, phase = m.group(1), m.group(2), m.group(3)
        if phase == "-done":
            continue  # counted at -start
        nbytes = _shape_bytes(shape_text)
        if (undo_cpu_promotion and kind == "all-reduce"
                and "f32" in shape_text and _PROMOTED_RE.search(line)):
            nbytes //= 2  # bf16 on the TPU wire
        by_kind[kind] += nbytes
    return sum(by_kind.values()), dict(by_kind)


def collective_count(hlo_text: str) -> int:
    return sum(1 for m in _OP_RE.finditer(hlo_text) if m.group(3) != "-done")


# The `_c10d_functional` operators DTensor's redistributions lower to, by
# the reference's kind names. A permute is a point-to-point
# `_dtensor.shard_dim_alltoall` or a `permute_tensor`, which DTensor emits
# for some layout changes.
GRAPH_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}


_NAMESPACES = ("_c10d_functional", "_dtensor")


def _collective_nodes(gm) -> Iterable[Tuple[str, object]]:
    """(kind, node) for each collective call of a captured FX graph."""
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if getattr(node.target, "namespace", None) not in _NAMESPACES:
            continue
        kind = GRAPH_COLLECTIVES.get(node.target.__name__.split(".")[0])
        if kind is not None:
            yield kind, node


def _value_bytes(val) -> int:
    """The bytes of a node's value: a tensor, or a list or tuple of them."""
    if isinstance(val, (list, tuple)):
        return sum(_value_bytes(v) for v in val)
    if hasattr(val, "numel") and hasattr(val, "element_size"):
        return int(val.numel()) * int(val.element_size())
    return 0


def graph_collective_bytes(gm) -> Tuple[int, Dict[str, int]]:
    """Total per-device collective bytes of a captured FX graph (its
    nodes' `meta["val"]`, the local result) + the per-kind breakdown under
    the reference's names; `wait_tensor` is not counted."""
    by_kind: Dict[str, int] = defaultdict(int)
    for kind, node in _collective_nodes(gm):
        by_kind[kind] += _value_bytes(node.meta.get("val"))
    return sum(by_kind.values()), dict(by_kind)


def graph_collective_count(gm) -> int:
    return sum(1 for _ in _collective_nodes(gm))
