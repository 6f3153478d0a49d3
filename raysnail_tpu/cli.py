"""CLI frontend mirroring the reference binary's flags
(src/bin/raysnail.rs:452-533): --scene/-f, --samples/-s, --passes/-p, -w,
--height, --outfile/-o. Defaults: 800x600, samples 122, passes 1, output.png.

Instead of the SDL2 preview window the renderer streams progress lines and a
progressively-updated PNG (--preview writes the accumulating image after each
pass/chunk)."""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="raysnail-tpu",
        description="differentiable path tracer for GPUs (JAX)")
    ap.add_argument("--scene", "-f", required=True, help="SDL scene file")
    ap.add_argument("-w", "--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--samples", "-s", type=int, default=122)
    ap.add_argument("--passes", "-p", type=int, default=1)
    ap.add_argument("--outfile", "-o", default="output.png")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (without it, a missing GPU is "
                         "an error)")
    ap.add_argument("--preview", action="store_true",
                    help="rewrite the output PNG as passes complete")
    ap.add_argument("--serve", type=int, nargs="?", const=8765, default=None,
                    metavar="PORT",
                    help="serve a live HTTP preview (the reference's SDL2 "
                         "window equivalent) on PORT [8765]")
    ap.add_argument("--mis", action="store_true",
                    help="physically-correct one-sample MIS instead of the "
                         "reference-compat estimator")
    ap.add_argument("--pallas", choices=["auto", "never", "force"],
                    default="auto",
                    help="mesh traversal route: auto = the Pallas kernel on a "
                         "GPU, the XLA walk on a CPU")
    ap.add_argument("--checkpoint", default=None,
                    help="write/read resumable render state at this path")
    args = ap.parse_args(argv)

    import jax

    from raysnail_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        ap.error(f"no GPU found (JAX sees {jax.devices()}); pass --cpu to "
                 f"render on the CPU")

    from PIL import Image

    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.prelude import color as colorlib
    from raysnail_tpu.render import render_passes
    from raysnail_tpu.sdl import build_scene

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.samples, max_depth=args.depth,
                       passes=args.passes, proper_mis=args.mis,
                       mesh_pallas=args.pallas)
    t0 = time.time()
    scene, camera = build_scene(args.scene, cfg)
    print(f"parsed + compiled {args.scene} in {time.time() - t0:.2f}s "
          f"({cfg.effective_samples} effective spp, {args.passes} pass(es))")

    server = None
    if args.serve is not None:
        from raysnail_tpu.io.preview import PreviewServer

        server = PreviewServer(port=args.serve)
        print(f"live preview at http://127.0.0.1:{server.port}/")

    def progress(done, total, img=None):
        print(f"  {done}/{total} samples", flush=True)
        if args.preview and img is not None:
            Image.fromarray(colorlib.to_u8(img)).save(args.outfile)
        if server is not None:
            return server.target(done, total, img)

    t0 = time.time()
    if args.checkpoint and args.passes == 1:
        import os

        from raysnail_tpu.painter import RenderSession, RenderState

        sess = RenderSession(scene, camera, cfg, seed=args.seed,
                             checkpoint_path=args.checkpoint)
        resume = (RenderState.load(args.checkpoint)
                  if os.path.exists(args.checkpoint) else None)
        img = sess.render(target=progress, resume=resume)
    else:
        img = render_passes(scene, camera, cfg, seed=args.seed, progress=progress)
    dt = time.time() - t0
    rays = cfg.width * cfg.height * cfg.effective_samples * args.passes
    print(f"rendered in {dt:.2f}s  ({rays / dt / 1e6:.2f} Mprimary-rays/s)")

    Image.fromarray(colorlib.to_u8(img)).save(args.outfile)
    print(f"wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
