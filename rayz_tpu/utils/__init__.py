from . import compile_cache, profiling, sampling, vec
from .compile_cache import enable_compile_cache
from .profiling import RenderStats, timed_render, trace

__all__ = ["vec", "sampling", "profiling", "compile_cache",
           "enable_compile_cache", "RenderStats", "timed_render", "trace"]
