"""Command-line renderer, mirroring the reference CLI
(/root/reference/src/rayz.zig:12-43): positional image width, optional output
path (default: PPM to stdout), timed render printing rays/s and us/ray in the
reference's format (rayz.zig:30-34). Extras beyond the reference: scene
selection, spp/depth/seed flags, PNG output by extension, and sharded
multi-device rendering.

Usage:
    python -m rayz_tpu 512 out.ppm
    python -m rayz_tpu 512 out.png --scene cornell_box --spp 64 --depth 32
"""

from __future__ import annotations

import argparse
import sys
import time

import jax

from . import RenderConfig, render_fast, scenes, write_png, write_ppm
from .ops.engine import ENGINES, pick_engine
from .ops.megakernel import render_pallas_sharded
from .parallel import make_mesh, render_sharded_jit
from .utils.compile_cache import enable_compile_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rayz_tpu", description=__doc__)
    p.add_argument("width", type=int, help="image width in pixels")
    p.add_argument("output", nargs="?", default=None,
                   help="output path (.ppm or .png); default: PPM to stdout")
    p.add_argument("--scene", default="random_bouncing", choices=sorted(scenes.SCENES))
    p.add_argument("--height", type=int, default=None,
                   help="image height (default: the scene's own aspect — "
                        "16:9 like the reference, or square)")
    p.add_argument("--spp", type=int, default=10,
                   help="samples per pixel (reference default 10)")
    p.add_argument("--depth", type=int, default=50,
                   help="max bounces (reference default 50)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--t-min", type=float, default=1e-3)
    p.add_argument("--chunk", type=int, default=None,
                   help="rays per chunk (memory bound)")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels over all visible devices")
    p.add_argument("--engine", default="auto", choices=("auto",) + ENGINES,
                   help="render engine: the fused path-trace kernel (GPU) "
                        "or the XLA integrator; auto picks the kernel on "
                        "the GPU for every scene it supports")
    p.add_argument("--progress", action="store_true",
                   help="print in-render progress (reference "
                        "renderer.zig:84 format) by accumulating spp "
                        "progressively — a fused render is one device "
                        "call, so progress is reported per sample chunk "
                        "instead of per row")
    args = p.parse_args(argv)
    enable_compile_cache()

    scene, camera = scenes.SCENES[args.scene](width=args.width,
                                              height=args.height)
    cfg = RenderConfig(spp=args.spp, max_depth=args.depth, t_min=args.t_min,
                       chunk_size=args.chunk)
    key = jax.random.PRNGKey(args.seed)

    engine = pick_engine(scene, args.engine)
    if args.sharded:
        mesh = make_mesh()
        if engine == "pallas":
            run = lambda verbose=True: render_pallas_sharded(
                scene, camera, key, cfg, mesh)
        else:
            run = lambda verbose=True: render_sharded_jit(
                scene, camera, key, cfg, mesh)
    elif args.progress and args.spp > 1:
        # progressive accumulation: n_chunks device calls, reference-format
        # progress line between them (renderer.zig:84: "\rProgress: X.XX%"
        # on stderr). Distribution is unchanged — chunk keys are folds of
        # the run key and the chunks average with spp weights. Chunks stay
        # at >= 16 spp where possible: fewer, larger device calls.
        n_chunks = (max(1, min(10, args.spp // 16)) if args.spp >= 16
                    else min(args.spp, 10))
        base, extra = divmod(args.spp, n_chunks)
        sizes = [base + (1 if i < extra else 0) for i in range(n_chunks)]

        def run(verbose=True):
            acc = None
            done = 0
            for i, s in enumerate(sizes):
                if verbose:
                    print(f"\rProgress: {100.0 * done / args.spp:.2f}%",
                          end="", file=sys.stderr)
                ccfg = RenderConfig(spp=s, max_depth=args.depth,
                                    t_min=args.t_min,
                                    chunk_size=args.chunk)
                img = jax.block_until_ready(render_fast(
                    scene, camera, jax.random.fold_in(key, i), ccfg,
                    engine=engine))
                acc = img * s if acc is None else acc + img * s
                done += s
            if verbose:
                print("\rProgress: 100.00%", file=sys.stderr)
            return acc / args.spp
    else:
        run = lambda verbose=True: render_fast(scene, camera, key, cfg,
                                               engine=engine)

    # Compile outside the timed region (the reference has no compile step;
    # the progress sweep stays quiet during warmup).
    jax.block_until_ready(run(verbose=False))
    st = time.perf_counter()
    img = jax.block_until_ready(run())
    dur = time.perf_counter() - st

    # camera-ray count, matching the reference's metric (renderer.zig:90-92:
    # one ray counted per pixel-sample)
    rays = camera.height * camera.width * args.spp
    print(
        f"Finished render ({dur:.2f}s): {rays / dur:.2f} rps and "
        f"{dur / rays * 1e6:.2f} us per ray",
        file=sys.stderr,
    )

    if args.output is None:
        write_ppm(img, sys.stdout.buffer)
    elif args.output.endswith(".png"):
        write_png(img, args.output)
    else:
        write_ppm(img, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
