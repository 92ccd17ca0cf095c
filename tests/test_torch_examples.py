"""The port's examples beside the reference's (`examples/*_torch.py`) run
on the CPU through their `main(argv)` with `--device cpu`, each with the
reference example's own checks, which raise on failure."""
import importlib.util
import pathlib

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _main(name):
    path = EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("name,expect", [
    ("quickstart_torch", "streamed"),
    ("gcn_serve_torch", "epoch 1: uploaded 0 B"),
    ("lm_serve_torch", "served batch of 4 requests"),
    ("ooc_expert_streaming_torch", "streamed 24 aligned expert blocks"),
])
def test_example_runs_on_cpu(name, expect, capsys):
    _main(name)(["--device", "cpu"])
    out = capsys.readouterr().out
    assert expect in out
    assert out.rstrip().splitlines()[-1] == "OK"


def test_examples_default_to_the_card():
    """Without `--device` each example asks for CUDA, and without a card
    it raises rather than running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run there")
    for name in ("quickstart_torch", "gcn_serve_torch", "lm_serve_torch",
                 "ooc_expert_streaming_torch"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            _main(name)([])
