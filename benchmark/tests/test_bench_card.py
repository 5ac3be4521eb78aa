"""On the card (skips without one): the control, the reference computed in
TF32 in the program's place, fails the cell's limits at the cell's own
size on three seeds, while the program passes them."""

import pytest

from benchmark.harness.readings import readings
from benchmark.harness.spec import load_cell


@pytest.mark.card
@pytest.mark.parametrize("name", ["stft.serve", "world.serve", "stft.stream"])
def test_control_fails_and_program_passes(name, card):
    cell = load_cell(name)
    for row in readings(cell, [2**31 + 101, 2**32 + 5, 3 * 2**31 + 9], 4.0, card):
        assert not row["problems"]
        assert all(row["program"][k] <= lim for k, lim in cell.limits.items())
        assert any(row["control"][k] > lim for k, lim in cell.limits.items())
