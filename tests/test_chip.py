"""The chip_smoke.py phases as tests: they need a GPU and skip elsewhere
(the `gpu` fixture). On the card, `python chip_smoke.py` runs the same
functions in one process."""

import pytest

import chip_smoke

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.ONE_CARD])
def test_chip_phase(gpu, name):
    dict(chip_smoke.ONE_CARD)[name]()


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.FOUR_CARDS])
def test_chip_multichip_phase(gpu, name):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs four GPUs")
    dict(chip_smoke.FOUR_CARDS)[name]()
