"""Benchmark: forward Mrays/s of the BASELINE render configs and
forward+backward Mrays/s of the flagship, on one GPU.

Configs (BASELINE.json): two_sphere 256x256 4 spp depth 8, three_sphere
512x512 16 spp depth 16, random_bouncing (the RTIOW final scene, ~500
spheres, 80% moving) 512x512 64 spp depth 32, cornell_box 512x512 64 spp
depth 32. Forward runs ``render_fast(engine="auto")``; forward+backward runs
``jax.value_and_grad(pixel_loss)`` with the dense engine on the flagship.

The ray metric is the reference's own counter (rayz.zig:26-34): one camera
ray per pixel-sample, over wall-clock seconds, taken on the host clock
around ``block_until_ready`` with compilation excluded. Each cell reports
the median and spread of RUNS runs with different seeds. The script fails on
a machine without a GPU and prints ONE JSON line naming the device and the
card (name, power limit).

Run from the repository root: ``python bench.py``.
"""

from __future__ import annotations

import json
import statistics
import time

import jax

import rayz_tpu as rt
from rayz_tpu.diff import extract_params, pixel_loss
from rayz_tpu.ops.engine import pick_engine
from rayz_tpu.utils.compile_cache import enable_compile_cache
from rayz_tpu.utils.device import card, device_info, require_gpu

CONFIGS = [  # (scene, width, height, spp, depth)
    ("two_sphere", 256, 256, 4, 8),
    ("three_sphere", 512, 512, 16, 16),
    ("random_bouncing", 512, 512, 64, 32),
    ("cornell_box", 512, 512, 64, 32),
]
RUNS = 5


def _measure(fn):
    """Compile seconds and RUNS timed seconds of ``fn(seed)``."""
    st = time.perf_counter()
    jax.block_until_ready(fn(0))
    compile_s = time.perf_counter() - st
    times = []
    for seed in range(1, RUNS + 1):
        st = time.perf_counter()
        jax.block_until_ready(fn(seed))
        times.append(time.perf_counter() - st)
    return compile_s, times


def _cell(rays, compile_s, times):
    mrays = sorted(rays / t / 1e6 for t in times)
    return {"median_mrays_per_s": statistics.median(mrays),
            "min": mrays[0], "max": mrays[-1], "runs": len(mrays),
            "first_call_s": compile_s}


def main() -> None:
    require_gpu()
    enable_compile_cache()
    cells = {}
    for name, w, h, spp, depth in CONFIGS:
        scene, camera = rt.scenes.SCENES[name](width=w, height=h)
        config = rt.RenderConfig(spp=spp, max_depth=depth)
        engine = pick_engine(scene, "auto")
        compile_s, times = _measure(lambda seed: rt.render_fast(
            scene, camera, seed, config, engine=engine))
        cells[f"{name}_fwd"] = dict(engine=engine, **_cell(
            w * h * spp, compile_s, times))

    name, w, h, spp, depth = CONFIGS[2]
    scene, camera = rt.scenes.random_bouncing(width=w, height=h)
    config = rt.RenderConfig(spp=spp, max_depth=depth)
    target = rt.render_fast(scene, camera, 0, config)
    params = extract_params(scene)
    grad_fn = jax.jit(jax.value_and_grad(pixel_loss),
                      static_argnames=("config", "engine"))
    compile_s, times = _measure(lambda seed: grad_fn(
        params, scene, camera, jax.random.PRNGKey(seed), target, config,
        "dense"))
    cells[f"{name}_fwdbwd"] = dict(engine="dense", **_cell(
        w * h * spp, compile_s, times))

    flagship = cells["random_bouncing_fwd"]["median_mrays_per_s"]
    print(json.dumps({
        "metric": "fwd_mrays_per_s",
        "value": flagship,
        "unit": "Mrays/s",
        "device": device_info(),
        "card": card(),
        "cells": cells,
    }))


if __name__ == "__main__":
    main()
