"""Smoke test of the renderer's main path on the GPU, in one process.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # one card: every phase below
    python3 chip_smoke.py --multi    # four cards: sharded render and fit only

Phases (one card): the device; compiling the path-trace kernel and the XLA
forward at the flagship's shapes; the tests marked ``gpu`` (compiled kernel
vs XLA on deterministic scenes, a float32 gradient vs finite differences);
deterministic parity of kernel, XLA and the committed golden image;
statistical parity and Mrays/s of both engines on the flagship
(``random_bouncing``, 512x512, 64 spp, depth 32) and the Cornell box; the
dense gradient at the flagship and five Adam steps of ``fit`` on the
inverse-rendering scene; the CLI writing the flagship PNG. Any failed check
raises, so the exit code is non-zero; the last line of standard output is
one JSON object naming the device, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

# JAX falls back to the CPU when its CUDA plugin fails; pin it to CUDA so
# that a machine without a usable GPU fails here instead of passing.
os.environ["JAX_PLATFORMS"] = "cuda"

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import rayz_tpu as rt  # noqa: E402
from rayz_tpu.diff import extract_params, fit, make_train_step, pixel_loss  # noqa: E402
from rayz_tpu.ops import megakernel  # noqa: E402
from rayz_tpu.ops.engine import pick_engine  # noqa: E402
from rayz_tpu.parallel import make_mesh, render_sharded_jit  # noqa: E402
from rayz_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from rayz_tpu.utils.device import card, device_info, require_gpu  # noqa: E402

from parity import statistical_parity  # noqa: E402
import test_golden  # noqa: E402

RUNS = 5
CELLS = [  # (scene, width, height, spp, depth); the first is the flagship
    ("random_bouncing", 512, 512, 64, 32),
    ("cornell_box", 512, 512, 64, 32),
]
FIT_WIDTH = 128
CLI_ARGS = ["512", "--spp", "64", "--depth", "32"]


@contextlib.contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    st = time.perf_counter()
    yield
    print(f"== {name}: ok ({time.perf_counter() - st:.1f} s)", flush=True)


def timed(fn, runs=RUNS):
    """Outputs and host-clock seconds of ``fn(seed)`` for seeds 1..runs,
    each synced with block_until_ready; the first call (compile) is apart."""
    st = time.perf_counter()
    jax.block_until_ready(fn(0))
    first = time.perf_counter() - st
    outs, times = [], []
    for seed in range(1, runs + 1):
        st = time.perf_counter()
        outs.append(jax.block_until_ready(fn(seed)))
        times.append(time.perf_counter() - st)
    return first, outs, times


def run_gpu_tests():
    """The tests marked ``gpu``, in this process (a second JAX process
    could not get the card's memory). All must run and pass."""
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes[report.nodeid] = report.outcome

    count = Count()
    rc = pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")], plugins=[count])
    bad = {k: v for k, v in count.outcomes.items() if v != "passed"}
    print(f"gpu tests: {len(count.outcomes) - len(bad)} passed, "
          f"not passed: {bad}")
    if rc != 0 or bad or not count.outcomes:
        raise SystemExit(f"gpu tests failed (pytest exit {rc})")


def single_card(card_line):
    name, w, h, spp, depth = CELLS[0]
    scene, camera = rt.scenes.SCENES[name](width=w, height=h)
    config = rt.RenderConfig(spp=spp, max_depth=depth)

    with phase("compile at the flagship's shapes"):
        assert pick_engine(scene, "auto") == "pallas"
        st = time.perf_counter()
        kern = megakernel._render_impl.lower(
            scene, camera, jnp.int32(0), spp=config.spp,
            max_depth=config.max_depth, t_min=config.t_min,
            jitter=config.jitter, block=megakernel.BLOCK,
            interpret=False).compile()
        print(f"kernel: compiled in {time.perf_counter() - st:.1f} s; "
              f"{kern.memory_analysis()}")
        st = time.perf_counter()
        xla = rt.render_jit.lower(scene, camera, jax.random.PRNGKey(0),
                                  config).compile()
        print(f"xla forward: compiled in {time.perf_counter() - st:.1f} s; "
              f"{xla.memory_analysis()}")

    with phase("tests marked gpu"):
        run_gpu_tests()

    with phase("deterministic parity: kernel, XLA and the golden image"):
        test_golden.check_golden(test_golden._engines(interpret=False))

    for name, w, h, spp, depth in CELLS:
        with phase(f"forward: {name} {w}x{h} {spp} spp depth {depth}"):
            sc, cam = rt.scenes.SCENES[name](width=w, height=h)
            cfg = rt.RenderConfig(spp=spp, max_depth=depth)
            assert pick_engine(sc, "auto") == "pallas"
            rays = w * h * spp
            results = {}
            for label, fn in (
                    ("kernel (auto)", lambda s: rt.render_fast(
                        sc, cam, s, cfg, engine="auto")),
                    ("xla", lambda s: rt.render_jit(
                        sc, cam, jax.random.PRNGKey(s), cfg))):
                first, outs, times = timed(fn)
                med = statistics.median(times)
                results[label] = outs
                print(f"{name} {label}: median {rays / med / 1e6:.3f} "
                      f"Mrays/s ({med:.4f} s; runs "
                      f"{[round(t, 4) for t in times]}; first call "
                      f"{first:.1f} s) on {card_line}")
                for img in outs:
                    assert img.shape == (h, w, 3)
                    assert bool(jnp.isfinite(img).all()), label
            res = statistical_parity(
                np.asarray(results["kernel (auto)"][0]),
                np.asarray(results["xla"][0]), np.asarray(results["xla"][1]),
                block=16, mean_rtol=0.01, n_se=5.0)
            print(f"{name} statistical parity: {res}")
            assert res["ok"], res

    with phase("gradient: dense value_and_grad at the flagship"):
        target = rt.render_fast(scene, camera, 0, config)
        params = extract_params(scene)
        grad_fn = jax.jit(jax.value_and_grad(pixel_loss),
                          static_argnames=("config", "engine"))
        print(f"microbatch: none (all {spp} spp in one call)")
        first, outs, times = timed(lambda s: grad_fn(
            params, scene, camera, jax.random.PRNGKey(s), target, config,
            "dense"), runs=2)
        loss, grads = outs[-1]
        med = statistics.median(times)
        stats = jax.devices()[0].memory_stats() or {}
        print(f"loss {float(loss):.6g}; median {med:.3f} s = "
              f"{w * h * spp / med / 1e6:.3f} Mrays/s fwd+bwd (first call "
              f"{first:.1f} s) on {card_line}; peak bytes "
              f"{stats.get('peak_bytes_in_use')}")
        assert bool(jnp.isfinite(loss))
        for k, g in grads.items():
            if g.size:  # the flagship has no triangles
                assert bool(jnp.isfinite(g).all()), k
                print(f"  |grad {k}|_max = {float(jnp.abs(g).max()):.4g}")
        assert float(jnp.abs(grads["tex_color"]).max()) > 0

    with phase("fit: 5 Adam steps on sphere_grid (BASELINE config 5)"):
        grid, cam = rt.scenes.sphere_grid(100, width=FIT_WIDTH)
        cfg = rt.RenderConfig(spp=8, max_depth=3)
        tgt = rt.render(grid, cam, jax.random.PRNGKey(7),
                        rt.RenderConfig(spp=32, max_depth=3))
        rng = np.random.default_rng(1)
        wrong = grid.replace(tex_color=jnp.clip(
            grid.tex_color + rng.normal(0, 0.15, grid.tex_color.shape),
            0.02, 0.98).astype(grid.tex_color.dtype))
        _, hist = fit(wrong, cam, tgt, config=cfg, steps=5,
                      learning_rate=5e-2, fields=("tex_color",),
                      key=jax.random.PRNGKey(2))
        print(f"loss history {hist}")
        assert hist[-1] < hist[0], hist

    with phase(f"CLI: {' '.join(CLI_ARGS)} (flagship PNG)"):
        from rayz_tpu import cli

        out = os.path.join(REPO, "chiprun_out", "chip_smoke_flagship.png")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        if os.path.exists(out):
            os.remove(out)
        assert cli.main([CLI_ARGS[0], out, *CLI_ARGS[1:]]) == 0
        with open(out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        print(f"wrote {out} ({os.path.getsize(out)} bytes)")


def four_cards(card_line):
    devices = jax.devices()
    assert len(devices) == 4, devices
    mesh = make_mesh(devices)
    scene, _ = test_golden._scene()
    camera = rt.make_camera(width=512, height=384, vfov=55.0, focus_dist=1.0,
                            look_from=(0, 0.2, 0.6), look_at=(0, 0, -2))
    config = test_golden.CFG
    key = jax.random.PRNGKey(0)

    with phase("sharded forward on a 1-D mesh of 4 cards vs 1 card"):
        for label, sharded, single in (
                ("xla", lambda: render_sharded_jit(scene, camera, key, config,
                                                   mesh),
                 lambda: rt.render_jit(scene, camera, key, config)),
                ("kernel", lambda: rt.render_pallas_sharded(
                    scene, camera, 0, config, mesh),
                 lambda: rt.render_pallas(scene, camera, 0, config))):
            a = np.asarray(jax.block_until_ready(sharded()))
            b = np.asarray(jax.block_until_ready(single()))
            err = float(np.abs(a - b).max())
            print(f"{label}: max |4 cards - 1 card| = {err:.3g}; values off "
                  f"by more than 1e-5: {int((np.abs(a - b) > 1e-5).sum())} "
                  f"of {a.size}")
            assert err <= 1e-5, (label, err)

    with phase("data-parallel train step on 4 cards vs 1 card"):
        params = extract_params(scene, ("sphere_center", "tex_color"))
        opt = optax.sgd(1.0)  # new params = params - grads
        target = jnp.zeros((camera.height, camera.width, 3), jnp.float32)
        outs = {}
        for label, m in (("1 card", None), ("4 cards", mesh)):
            step = make_train_step(opt, config, m)
            p, _, loss = jax.block_until_ready(step(
                params, opt.init(params), scene, camera, key, target))
            outs[label] = (float(loss), {k: np.asarray(params[k] - p[k])
                                         for k in params})
        (l1, g1), (l4, g4) = outs["1 card"], outs["4 cards"]
        print(f"loss: 1 card {l1!r}, 4 cards {l4!r}")
        assert abs(l4 - l1) <= 1e-5 * abs(l1), (l1, l4)
        for k in g1:
            err = float(np.abs(g4[k] - g1[k]).max())
            scale = float(np.abs(g1[k]).max())
            print(f"grad {k}: max |4 - 1| = {err:.3g} (max |grad| {scale:.3g})")
            assert err <= 1e-4 * scale + 1e-7, (k, err, scale)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card sharded render and fit")
    args = p.parse_args()

    with phase("device"):
        require_gpu()
        enable_compile_cache()
        info = device_info()
        card_line = card()
        print(f"device: {info}")
        print(card_line)  # nvidia-smi's "name, power.limit"

    if args.multi:
        four_cards(card_line)
    else:
        single_card(card_line)
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
