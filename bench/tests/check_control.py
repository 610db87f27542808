"""On the card: the control (the reference put in the program's place at
TF32, the precision below the configurations' float32) comes out not
correct, at a small size of every cell."""
import pytest

from bench.tests.common import small_config, spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", spec.cell_names())
def test_control_is_not_correct(cell, card):
    c, cfg = small_config(cell)
    numbers = spec.load_driver(c["entry"]).control_outputs(
        c, cfg, (1 << 31) + 21, card)
    assert not all(n.ok for n in numbers), [n.line() for n in numbers]
