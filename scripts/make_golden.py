#!/usr/bin/env python
"""Regenerate golden regression anchors (tests/golden/golden.npz).

    python scripts/make_golden.py            # anchors missing from the archive
    python scripts/make_golden.py NAME ...   # re-render these anchors
    python scripts/make_golden.py --all      # re-render every anchor

Anchors not re-rendered keep their committed arrays unchanged; anchors no
longer in utils/golden.golden_configs() are dropped. Run this ONLY after an
intended estimator or route change, on the CPU backend, and eyeball the PNGs
it drops in docs/renders/golden/ before committing."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from raysnail_tpu.utils import golden  # noqa: E402


def main():
    os.makedirs(os.path.dirname(golden.GOLDEN_PATH), exist_ok=True)
    png_dir = os.path.join(golden.REPO, "docs", "renders", "golden")
    os.makedirs(png_dir, exist_ok=True)

    configs = golden.golden_configs()
    old = dict(np.load(golden.GOLDEN_PATH)) if os.path.exists(
        golden.GOLDEN_PATH) else {}
    have = {k.split("/")[0] for k in old}
    if "--all" in sys.argv[1:]:
        names = list(configs)
    else:
        names = [a for a in sys.argv[1:] if not a.startswith("-")] or [
            n for n in configs if n not in have]
    unknown = sorted(set(names) - set(configs))
    if unknown:
        sys.exit(f"unknown anchors: {unknown}")
    arrays = {k: v for k, v in old.items()
              if k.split("/")[0] in configs and k.split("/")[0] not in names}
    for name in names:
        t0 = time.time()
        img = golden.render_anchor(name)
        stats = golden.anchor_stats(img)
        for field, value in stats.items():
            arrays[f"{name}/{field}"] = value
        print(f"{name}: {img.shape} mean={stats['mean']} "
              f"({time.time() - t0:.1f}s)")
        try:
            from PIL import Image
            Image.fromarray(
                (np.clip(img, 0, 1) * 255).astype(np.uint8)
            ).save(os.path.join(png_dir, f"{name.replace('.', '_')}.png"))
        except Exception as e:  # noqa: BLE001
            print(f"  (png skipped: {e})")

    np.savez(golden.GOLDEN_PATH, **arrays)
    print(f"wrote {golden.GOLDEN_PATH}")


if __name__ == "__main__":
    main()
