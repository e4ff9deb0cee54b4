"""Choices made by platform, and where the compile cache lives."""

import os

import jax
import pytest

from cudapathtracer import RenderConfig
from cudapathtracer.render import renderer
from cudapathtracer.utils import compile_cache


@pytest.mark.parametrize("backend,expected", [("cpu", "packets"),
                                              ("gpu", "cuda")])
def test_auto_traversal_by_platform(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert renderer.resolve_traversal(RenderConfig()) == expected
    # an explicit choice is never overridden
    for kind in ("packets", "bvh", "cuda", "brute"):
        cfg = RenderConfig(traversal=kind)
        assert renderer.resolve_traversal(cfg) == kind


def test_removed_engine_options_are_gone():
    with pytest.raises(TypeError):
        RenderConfig(packet_engine="xla")
    with pytest.raises(AssertionError):
        RenderConfig(traversal="pallas")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert compile_cache.cache_dir() == str(tmp_path)
    assert calls == []  # nothing else is set in code


def test_compile_cache_default_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    d = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(repo, ".jax_cache")
    assert compile_cache.cache_dir() == d
    assert calls == [("jax_compilation_cache_dir", d)]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
