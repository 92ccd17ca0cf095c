#!/usr/bin/env python3
"""Sweep of the softcapped bf16 flash backward against its plain version
over seeded draws of the output gradient, on one card.

The inputs are those of
`tests/test_torch_gpu.py::test_softcapped_flash_under_autograd_raises_on_card`
(q, k, v (1, 2, 64, 64) bf16 from seed 5, softcap 1.0); draw i of dO comes
from a CUDA generator seeded with i. For every draw the kernel's gradients
(`ops.flash_attention` under autograd) are held to two plain backwards,
each element by that test's `BWD_TOL` rule (|got - want| <= rtol·|want| +
atol·M, M the largest |want| over dQ, dK, dV):

  * "plain": the plain backward from the plain forward's out and lse, the
    comparison the test made before it was repaired;
  * "plain_kernel_fwd": the plain backward from the kernel's own out and
    lse, so that only the backward's arithmetic differs (the repaired
    test's comparison).

For each it prints the draws with an element past the rule, the elements,
and the largest excess over the rule in units of the rule's bound.

    python3 scripts/softcap_bwd_sweep.py [--draws 256]

Prints one JSON line, with the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# tests/test_torch_gpu.py BWD_TOL for bf16: (rtol, atol).
RTOL, ATOL = 2.0 ** -7, 2e-5


def excess(got, want):
    """(elements past the rule, the largest |got - want| / bound)."""
    scale = max(float(w.double().abs().max()) for w in want)
    n, worst = 0, 0.0
    for g, w in zip(got, want):
        err = (g.double() - w.double()).abs()
        bound = RTOL * w.double().abs() + ATOL * scale
        n += int((err > bound).sum())
        worst = max(worst, float((err / bound).max()))
    return n, worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=256)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("softcap_bwd_sweep.py: no CUDA device")
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    q, k, v = [torch.randn((1, 2, 64, 64), generator=gen).to(
        device=dev, dtype=torch.bfloat16) for _ in range(3)]
    cap = 1.0
    out_p, lse_p = fmod.flash_attention_plain_lse(q, k, v, softcap=cap)
    with torch.no_grad():
        out_k, lse_k = fmod.flash_attention_lse_cuda(q, k, v, softcap=cap)

    rows = {"plain": [], "plain_kernel_fwd": []}
    for i in range(args.draws):
        dgen = torch.Generator(device=dev).manual_seed(i)
        dout = torch.randn(out_p.shape, generator=dgen, device=dev,
                           dtype=torch.bfloat16)
        live = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.flash_attention(*live, softcap=cap).backward(dout)
        got = [t.grad for t in live]
        plain = fmod.flash_attention_bwd_plain(q, k, v, out_p, dout, lse_p,
                                               softcap=cap)
        plain_k = fmod.flash_attention_bwd_plain(q, k, v, out_k, dout, lse_k,
                                                 softcap=cap)
        for name, want in (("plain", plain), ("plain_kernel_fwd", plain_k)):
            n, worst = excess(got, want)
            rows[name].append((i, n, worst))

    def summary(name):
        bad = [r for r in rows[name] if r[1]]
        return {"draws_failing": len(bad),
                "elements_failing": sum(r[1] for r in bad),
                "worst_excess": max(r[2] for r in rows[name]),
                "failing": [{"draw": i, "elements": n, "excess": w}
                            for i, n, w in bad]}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "draws": args.draws, "card": smi, "torch": torch.__version__,
        **{name: summary(name) for name in rows}}))


if __name__ == "__main__":
    main()
