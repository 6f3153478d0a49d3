"""Statistical comparison against the reference's only checked-in render.

The reference ships exactly one rendered output: examples/sdl_quadrics.jpg
(referenced by its README.md:7), produced by the raysnail CLI from
sdl/quadric.sdl at 800x500. Rust cannot run in this image, so this is the
one executable render-level parity check available: compare that artifact
against this framework's committed render of the SAME scene
(docs/renders/quadric_sdl_800x500_121spp.png, created by
`python -m raysnail_tpu --scene sdl/quadric.sdl -w 800 --height 500
--samples 122` — full reference resolution, 121 effective spp).

Method: compare at the reference's native 800x500 (box-downsample only if
`ours` is smaller), reporting PSNR, mean |diff|, percentiles, pixel
correlation, and the in-tolerance fraction. Recorded round-4: PSNR
38.6 dB / corr 0.9992 at 121 spp (the round-3 400x250@36spp comparison
read 28.4 dB — noise-dominated); see
docs/REFERENCE_PARITY.md.

Usage: python scripts/compare_reference.py
"""

import json
import math
import os

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_JPG = "/root/reference/examples/sdl_quadrics.jpg"
OURS_PNG = os.path.join(REPO, "docs", "renders",
                        "quadric_sdl_800x500_121spp.png")


def compare(ref_path: str = REF_JPG, ours_path: str = OURS_PNG) -> dict:
    ref = np.asarray(Image.open(ref_path).convert("RGB"), np.float32) / 255.0
    ours = np.asarray(Image.open(ours_path).convert("RGB"), np.float32) / 255.0
    fy = ref.shape[0] // ours.shape[0]
    fx = ref.shape[1] // ours.shape[1]
    assert fy >= 1 and fx >= 1 and ref.shape[0] % ours.shape[0] == 0
    ref2 = ref.reshape(ours.shape[0], fy, ours.shape[1], fx, 3).mean((1, 3))
    diff = ref2 - ours
    m = float((diff ** 2).mean())
    return {
        "psnr_db": round(10 * math.log10(1.0 / m), 2),
        "mean_abs_diff": round(float(np.abs(diff).mean()), 5),
        "p50_abs_diff": round(float(np.percentile(np.abs(diff), 50)), 5),
        "p95_abs_diff": round(float(np.percentile(np.abs(diff), 95)), 5),
        "p99_abs_diff": round(float(np.percentile(np.abs(diff), 99)), 5),
        "pixel_correlation": round(float(np.corrcoef(ref2.ravel(), ours.ravel())[0, 1]), 5),
        "frac_within_0p05": round(float((np.abs(diff) < 0.05).mean()), 5),
        "channel_mean_ref": [round(float(x), 5) for x in ref2.mean((0, 1))],
        "channel_mean_ours": [round(float(x), 5) for x in ours.mean((0, 1))],
    }


if __name__ == "__main__":
    print(json.dumps(compare(), indent=2))
