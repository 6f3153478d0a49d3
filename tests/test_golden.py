"""Golden regression gate: fixed-seed CPU renders must match the committed
anchor statistics (utils/golden.py). Catches silent estimator drift ("nothing
stops a silent estimator regression" was an early review's finding)."""

import pytest

from raysnail_tpu.utils import golden

GOLDEN = golden.load_golden()


@pytest.mark.parametrize("name", sorted(golden.golden_configs()))
def test_golden_anchor(name):
    assert name in GOLDEN, (
        f"no committed anchor for {name}; run scripts/make_golden.py")
    golden.check_anchor(name, GOLDEN)


def test_golden_detects_drift():
    """The gate must actually fail when the estimator drifts: a +5% brightness
    bias is far outside the committed tolerance."""
    import numpy as np

    name = "example.sdl"
    img = golden.render_anchor(name)
    stats = golden.anchor_stats(np.clip(img * 1.05, 0.0, 1.0))
    ref = GOLDEN[name]
    assert np.abs(stats["mean"] - ref["mean"]).max() > 0.003
