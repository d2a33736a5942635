"""On the card, at each cell's own size: a short sound run is correct,
and the check's control (the reference in TF32, the precision below the
configurations' f32, in the program's place) and a train cell's
half-batch fault each fail one of the cell's limits on three seeds.  The
benchmark's own runs do not run these; ``control.py`` takes the readings
that the limits were set from.  They skip without a card.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py -q
"""

import pytest
import torch

import harness
import tiny_cells

pytestmark = pytest.mark.cuda
SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)


def cell_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.cell(name)
    return cell, harness.driver(cell.traffic["driver"])


def context(cell, seed):
    return harness.Context(cell=cell, seed=seed, seconds=2.0, trace=False, device="cuda")


@pytest.mark.parametrize("name", tiny_cells.CELLS)
def test_short_run_is_correct(name):
    cell, _ = cell_on_card(name)
    result = tiny_cells.run(name, seed=SEEDS[0], seconds=2.0, cell=cell, device="cuda")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", tiny_cells.CELLS)
def test_control_fails_a_limit(name, seed):
    cell, drv = cell_on_card(name)
    checks = drv.control(context(cell, seed), list(range(cell.traffic.get("check_images", 0))))
    assert any(value > cell.limits[key] for key, value in checks.items()), checks


@pytest.mark.parametrize("seed", SEEDS)
def test_half_batch_fails_a_limit(seed):
    cell, drv = cell_on_card("fp-kitti.train.b12")
    checks = drv.half_batch(context(cell, seed))
    assert any(value > cell.limits[key] for key, value in checks.items()), checks
