"""Subprocess body for the REAL 2-process distributed test (SURVEY.md §5
multi-host plan): each process owns 4 virtual CPU devices, joins via a
loopback coordinator with ``jax.distributed.initialize``, renders a shard of
the image over the 8-device GLOBAL mesh, runs one data-parallel train step
with psum'd gradients, and host 0 assembles the full image through
``assemble_global_image``'s ``process_allgather`` branch — the code path a
single-process test can never execute.

Usage: python multihost_worker.py <pid> <nproc> <port> <out.npz>
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
out = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

from rayz_tpu.parallel import multihost  # noqa: E402

multihost.initialize(f"127.0.0.1:{port}", nproc, pid)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import rayz_tpu as rt  # noqa: E402
from rayz_tpu.diff import extract_params, make_train_step  # noqa: E402
from rayz_tpu.parallel import render_sharded_jit  # noqa: E402

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.local_devices()) == 4
assert len(jax.devices()) == 4 * nproc

mesh = multihost.global_mesh()
assert mesh.size == 4 * nproc

# Fuzz-0 metal scene + jitter off: radiance is deterministic (no random
# numbers reach the output), so the multi-process render must equal the
# single-process one exactly-ish regardless of per-device RNG streams.
b = rt.SceneBuilder()
m = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
b.add_sphere((0, -100.5, -2), 100.0, m)
b.add_sphere((0, 0, -2), 0.5, m)
scene = b.build(dtype=jnp.float32)
cam = rt.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                     look_from=(0, 0, 0), look_at=(0, 0, -1),
                     dtype=jnp.float32)
cfg = rt.RenderConfig(spp=1, max_depth=4, jitter=False)

img = render_sharded_jit(scene, cam, jax.random.PRNGKey(0), cfg, mesh)
full = multihost.assemble_global_image(img)

# one data-parallel train step over the global mesh: per-device render +
# backward, psum'd gradients across the two processes
params = extract_params(scene, ("tex_color",))
opt = optax.adam(1e-2)
step = make_train_step(opt, cfg, mesh, engine="dense")
target = jnp.zeros((16, 16, 3), jnp.float32)
params2, _, loss = step(params, opt.init(params), scene, cam,
                        jax.random.PRNGKey(1), target)
loss = float(loss)

if multihost.is_primary_host():
    assert full is not None and full.shape == (16, 16, 3)
    np.savez(out, img=full, loss=loss,
             tex_color=np.asarray(params2["tex_color"]))
else:
    # only host 0 gets the assembled image
    assert full is None

print(f"WORKER_OK {pid}", flush=True)
