"""Profiling and render metrics.

The reference's only observability is a wall-clock line printed after each
render — seconds, rays/s, and us/ray computed from the ray count returned by
``Tracer.render()`` (/root/reference/src/rayz.zig:24-34, renderer.zig:90-92;
its author profiled externally with Linux perf, .gitignore:5). The
equivalents here:

* :func:`timed_render` — the same metric (one camera ray per pixel-sample
  divided by wall-clock), measured with a device sync and with compile
  excluded, for any of this framework's render engines.
* :func:`trace` — a ``jax.profiler`` trace context producing XProf/TensorBoard
  dumps with per-kernel (path-trace kernel / XLA fusion) device timings, the
  analogue of the reference author's perf runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Iterator, Optional

import jax

__all__ = ["RenderStats", "timed_render", "trace"]


@dataclasses.dataclass(frozen=True)
class RenderStats:
    """Render timing in the reference's units (rayz.zig:30-34)."""

    seconds: float
    rays: int  # camera rays = pixels * spp (renderer.zig:90-92 convention)
    image: object  # the rendered image (device array)

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else float("inf")

    @property
    def us_per_ray(self) -> float:
        return self.seconds / self.rays * 1e6 if self.rays else 0.0

    def summary(self) -> str:
        """The reference's perf line format (rayz.zig:30-34)."""
        return (f"Finished render ({self.seconds:.2f}s): "
                f"{self.rays_per_s:.2f} rps and {self.us_per_ray:.2f} "
                f"us per ray")


def timed_render(render_fn: Callable[[], object], *, width: int, height: int,
                 spp: int, warmup: bool = True, best_of: int = 1) -> RenderStats:
    """Time ``render_fn`` with compile excluded, syncing on
    ``jax.block_until_ready``. ``best_of`` repeats the timed run and keeps
    the fastest.
    """
    if warmup:
        jax.block_until_ready(render_fn())
    best = float("inf")
    img = None
    for _ in range(max(1, best_of)):
        start = time.perf_counter()
        img = jax.block_until_ready(render_fn())
        dur = time.perf_counter() - start
        best = min(best, dur)
    return RenderStats(seconds=best, rays=width * height * spp, image=img)


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_trace: bool = True) -> Iterator[None]:
    """``jax.profiler`` trace of everything inside the block; view the dump
    with XProf/TensorBoard (`tensorboard --logdir <log_dir>`) for per-kernel
    device timings. ``create_perfetto_trace`` additionally
    emits a perfetto-compatible ``.json.gz`` dump next to the XProf one."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=False,
                             create_perfetto_trace=create_perfetto_trace)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
