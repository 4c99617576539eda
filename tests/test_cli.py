"""CLI entry point (rayz.zig:12-43 analogue): argument shape, output
formats, perf line, and the --progress mode (renderer.zig:84)."""

import numpy as np

from rayz_tpu.cli import main
from rayz_tpu.io.image import read_ppm


def test_cli_ppm_and_progress(tmp_path, capfd):
    out = tmp_path / "img.ppm"
    rc = main(["24", str(out), "--scene", "two_sphere", "--spp", "4",
               "--depth", "3", "--engine", "xla", "--progress"])
    assert rc == 0
    img = read_ppm(str(out))
    assert img.shape == (24, 24, 3)
    assert np.isfinite(img).all() and img.max() > 0
    err = capfd.readouterr().err
    assert "Progress: 100.00%" in err     # reference progress format
    assert "Finished render" in err       # reference perf line


def test_cli_progress_weighted_accumulation_exact(tmp_path):
    """The progressive accumulator must equal the spp-weighted average of
    its chunk renders EXACTLY (same chunk keys, same estimator). spp=12
    splits into 10 chunks of spp 2/1 (cli.py sizes), so a missing ``* s``
    weight or wrong normalization shifts pixels far beyond the u8
    quantization this asserts to."""
    import jax

    from rayz_tpu import RenderConfig, render_fast, scenes
    from rayz_tpu.io.image import to_u8

    b = tmp_path / "b.ppm"
    spp, seed, depth = 12, 5, 3
    assert main(["24", str(b), "--scene", "two_sphere", "--spp", str(spp),
                 "--depth", str(depth), "--engine", "xla", "--seed",
                 str(seed), "--progress"]) == 0
    ib = read_ppm(str(b))

    # expected: the exact accumulation cli.py performs (fold_in chunk keys,
    # weight by chunk spp, divide by total)
    scene, camera = scenes.SCENES["two_sphere"](width=24, height=None)
    key = jax.random.PRNGKey(seed)
    n_chunks = min(spp, 10)
    base, extra = divmod(spp, n_chunks)
    sizes = [base + (1 if i < extra else 0) for i in range(n_chunks)]
    assert sorted(set(sizes)) == [1, 2]  # unequal weights ARE exercised
    acc = None
    for i, s in enumerate(sizes):
        cfg = RenderConfig(spp=s, max_depth=depth, t_min=1e-3)
        img = jax.block_until_ready(render_fast(
            scene, camera, jax.random.fold_in(key, i), cfg, engine="xla"))
        acc = img * s if acc is None else acc + img * s
    expected = to_u8(acc / spp)
    np.testing.assert_array_equal(ib, expected)
