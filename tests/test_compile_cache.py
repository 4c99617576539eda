"""Persistent compile cache location (rayz_tpu.utils.compile_cache): the
environment variable wins, and otherwise the cache sits at one fixed path
inside the checkout, so every run of every entry point hits the same one."""

import os

import jax
import pytest

from rayz_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_wins(monkeypatch, config_updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert config_updates == []  # JAX reads the variable itself


def test_default_is_fixed_path_in_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = os.path.join(REPO, ".jax_cache")
    assert compile_cache.DEFAULT_CACHE_DIR == expected
    assert compile_cache.enable_compile_cache() == expected
    assert config_updates == [("jax_compilation_cache_dir", expected)]


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_enables_the_cache(monkeypatch, tmp_path):
    from rayz_tpu import cli

    seen = []
    monkeypatch.setattr(cli, "enable_compile_cache", lambda: seen.append(1))
    out = tmp_path / "img.ppm"
    assert cli.main(["8", str(out), "--scene", "two_sphere", "--spp", "1",
                     "--depth", "1", "--engine", "xla"]) == 0
    assert seen == [1]
