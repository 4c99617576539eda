"""Multi-host bootstrap and image assembly (rayz_tpu.parallel.multihost).

The reference is single-process (SURVEY.md §2: no threads/processes/network),
so there is nothing to match numerically — these tests pin the BEHAVIOR of the
multi-host bootstrap: ``initialize()`` must actually call into
``jax.distributed`` in its no-arg auto-detect default (it was a silent no-op
once), must be idempotent when the launcher already initialized the runtime,
and must not swallow errors when an explicit coordinator is given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rayz_tpu as rt
from rayz_tpu.parallel import multihost
from rayz_tpu.utils.compile_cache import cache_dir


class _Recorder:
    def __init__(self, exc=None):
        self.calls = []
        self.exc = exc

    def __call__(self, **kw):
        self.calls.append(kw)
        if self.exc is not None:
            raise self.exc


def test_initialize_autodetect_calls_jax_distributed(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(jax.distributed, "initialize", rec)
    multihost.initialize()
    assert rec.calls == [{}]  # no-arg auto-detect path reached JAX


def test_initialize_swallows_no_cluster_error(monkeypatch):
    # Single-process environment: auto-detection finds no cluster and JAX
    # raises ValueError('coordinator_address should be defined.') — the
    # no-arg form proceeds single-process.
    rec = _Recorder(exc=ValueError("coordinator_address should be defined."))
    monkeypatch.setattr(jax.distributed, "initialize", rec)
    multihost.initialize()  # must not raise
    assert rec.calls == [{}]


def test_initialize_explicit_coordinator_forwards_and_raises(monkeypatch):
    rec = _Recorder(exc=ValueError("boom"))
    monkeypatch.setattr(jax.distributed, "initialize", rec)
    with pytest.raises(ValueError):
        multihost.initialize("10.0.0.1:1234", num_processes=2, process_id=0)
    assert rec.calls == [{
        "coordinator_address": "10.0.0.1:1234",
        "num_processes": 2,
        "process_id": 0,
    }]


def test_initialize_idempotent_when_already_up(monkeypatch):
    from jax._src import distributed

    rec = _Recorder()
    monkeypatch.setattr(jax.distributed, "initialize", rec)
    monkeypatch.setattr(distributed.global_state, "client", object())
    multihost.initialize()
    assert rec.calls == []  # launcher already initialized: no re-init


def test_assemble_single_process_roundtrip():
    img = jax.numpy.arange(12.0).reshape(2, 2, 3)
    out = multihost.assemble_global_image(img)
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, np.asarray(img))


def test_primary_host_and_global_mesh():
    assert multihost.is_primary_host()
    mesh = multihost.global_mesh()
    assert mesh.size == len(jax.devices())


def test_two_real_processes_loopback():
    """Spawn TWO actual processes with a loopback coordinator (4 virtual CPU
    devices each -> an 8-device global mesh), render over the global mesh,
    run one train step with psum'd gradients, and assemble the
    image on host 0 via process_allgather — the real cross-process code
    path. The deterministic metal scene makes the
    multi-process image comparable to a single-process reference."""
    import os
    import socket
    import subprocess
    import sys
    import tempfile

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "multihost_worker.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "host0.npz")
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        # repo only — an inherited site dir (e.g. an accelerator plugin
        # autoloader) would initialize the backend at import, before
        # distributed init
        env["PYTHONPATH"] = repo
        # the two workers compile identical 8-device programs: share the
        # repository's persistent compile cache (rayz_tpu.utils.compile_cache)
        env["JAX_COMPILATION_CACHE_DIR"] = cache_dir()
        env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "5"
        procs = [subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for pid in range(2)]
        outputs = []
        for p in procs:
            try:
                stdout, _ = p.communicate(timeout=1200)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outputs.append(stdout)
        for pid, (p, stdout) in enumerate(zip(procs, outputs)):
            assert p.returncode == 0, f"worker {pid} failed:\n{stdout[-3000:]}"
            assert f"WORKER_OK {pid}" in stdout
        data = np.load(out)

    # reference: single-process render + loss of the same deterministic scene
    b = rt.SceneBuilder()
    m = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, m)
    b.add_sphere((0, 0, -2), 0.5, m)
    scene = b.build(dtype=jnp.float32)
    cam = rt.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                         look_from=(0, 0, 0), look_at=(0, 0, -1),
                         dtype=jnp.float32)
    cfg = rt.RenderConfig(spp=1, max_depth=4, jitter=False)
    ref = np.asarray(rt.render(scene, cam, jax.random.PRNGKey(0), cfg))
    np.testing.assert_allclose(data["img"], ref, atol=1e-5)

    from rayz_tpu.diff import extract_params, pixel_loss
    params = extract_params(scene, ("tex_color",))
    ref_loss = float(pixel_loss(params, scene, cam, jax.random.PRNGKey(1),
                                jnp.zeros((16, 16, 3), jnp.float32), cfg,
                                "dense"))
    assert abs(float(data["loss"]) - ref_loss) < 1e-6
    assert np.isfinite(data["tex_color"]).all()
