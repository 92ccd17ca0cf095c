"""The port's out-of-core expert streaming (`repro_torch.io.weights`)
against the reference's `repro.io.weights` on the CPU.

The block plan must be the reference's exactly: `block_size` and
`blocks_for` over a grid of budgets (below one expert, at one, between
aligned counts, above the bank) and alignments; and `stream_layer` yields
the reference's blocks, value for value, in order, from banks made with
numpy from a seed (float32, and bfloat16 through ml_dtypes, which the
port holds as torch tensors by their bits). The port's `StreamStats`
count one segment and the block's bytes per block.
"""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.io import weights as r_weights
from repro_torch.io import ExpertBank, StreamedWeightProvider


def _arrays(n_experts, d, f, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w_gate": rng.standard_normal((n_experts, d, f)).astype(dtype),
            "w_up": rng.standard_normal((n_experts, d, f)).astype(dtype),
            "w_down": rng.standard_normal((n_experts, f, d)).astype(dtype)}


@pytest.mark.parametrize("n_experts", [1, 7, 64, 384])
@pytest.mark.parametrize("align", [1, 4, 8])
def test_block_plan_matches_reference(n_experts, align):
    arrays = _arrays(n_experts, 8, 4, seed=n_experts)
    r_bank = r_weights.ExpertBank(layer=0, arrays=arrays)
    p_bank = ExpertBank(layer=0, arrays=arrays)
    per = r_bank.expert_bytes()
    assert p_bank.expert_bytes() == per and p_bank.n_experts == n_experts
    for budget in (0, per - 1, per, 5 * per + 3, 8 * per, 13 * per,
                   n_experts * per, 10 * n_experts * per):
        r = r_weights.StreamedWeightProvider([r_bank], budget, align=align)
        p = StreamedWeightProvider([p_bank], budget, align=align,
                                   device="cpu")
        assert p.block_size == r.block_size, budget
        assert p.blocks_for(p_bank) == r.blocks_for(r_bank), budget
        assert p.block_size % align == 0


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_stream_layer_yields_the_reference_blocks(dtype):
    """Four layers of 64 experts (the reference example's bank), budget 12
    experts, align 4, depth 2: the same (first, end) ranges and the same
    values, block for block."""
    banks = [_arrays(64, 32, 16, seed=layer, dtype=dtype)
             for layer in range(4)]
    r_banks = [r_weights.ExpertBank(layer=i, arrays=a)
               for i, a in enumerate(banks)]
    p_banks = [ExpertBank(layer=i, arrays=a) for i, a in enumerate(banks)]
    per = r_banks[0].expert_bytes()
    r = r_weights.StreamedWeightProvider(r_banks, per * 12, align=4,
                                         depth=2)
    p = StreamedWeightProvider(p_banks, per * 12, align=4, depth=2,
                               device="cpu")
    n = 0
    for r_bank, p_bank in zip(r_banks, p_banks):
        got = list(p.stream_layer(p_bank))
        want = list(r.stream_layer(r_bank))
        assert [rng for rng, _ in got] == [rng for rng, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert set(g) == set(w)
            for name in w:
                ref = np.asarray(w[name])
                out = g[name]
                if dtype is ml_dtypes.bfloat16:
                    assert out.dtype == torch.bfloat16
                    out = out.view(torch.uint16).numpy().view(dtype)
                else:
                    out = out.numpy()
                np.testing.assert_array_equal(out, ref)
        n += len(got)
    assert p.stats.segments == n == 4 * 6
    assert p.stats.uploaded_bytes == 4 * 64 * per


def test_expert_bank_takes_tensors_and_refuses_mixed_counts():
    a = _arrays(10, 4, 2, seed=0)
    bank = ExpertBank(layer=1, arrays={k: torch.from_numpy(v)
                                       for k, v in a.items()})
    assert bank.n_experts == 10
    ids = [0, 3, 9]
    for name, block in bank.slice_experts(ids).items():
        np.testing.assert_array_equal(block.numpy(), a[name][ids])
    with pytest.raises(ValueError, match="expert count"):
        ExpertBank(layer=0, arrays={"w_gate": a["w_gate"],
                                    "w_up": a["w_up"][:5]})
