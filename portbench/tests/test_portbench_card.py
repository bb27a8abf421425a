"""On the card: each cell's control comes out not correct, at the cell's own
size and load, on three seeds, while the program comes out correct.

The control is the reference computed in TF32 (the nearest precision below
the configurations' float32) put in the program's place; in the training
cell the fault "half of the batch left out" is read too. Run on a machine
with the card, from the checkout's root (about ten minutes):

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda -q -s portbench/tests/test_portbench_card.py

Each seed's readings are printed as one JSON line (``-s`` shows them).
"""

import json

import pytest

SEEDS = (2147480001, 2147480002, 2147480003)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mmgan.train_none", "gandes.serve_n1", "mmgan.serve_n1"])
def test_the_control_fails_and_the_program_passes(cuda, cell):
    from portbench import run as R

    R.fix_caches()
    for seed in SEEDS:
        run, result = R.run_cell(cell, seed, 10, False, control=True)
        print(json.dumps({"cell": cell, "seed": seed, "program": result["checks"],
                          "control": run.control_readings}), flush=True)
        assert result["correct"], result["checks"]
        for kind, readings in run.control_readings.items():
            assert any(readings[n] > limit for n, _, limit in run.checks), (kind, readings)
