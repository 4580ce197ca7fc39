"""What of chip_smoke.py and the compile-cache helper can be checked
without a card: the script refuses to run off a GPU, its table check
catches a wrong count, and the cache directory follows the environment."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=240,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_table_check_catches_one_wrong_count():
    from tpu_debruijn import filter as F

    _, reads = chip_smoke.make_corpus(seed=3, scale=0.0005)
    ref = chip_smoke.reference_table(reads, 31, 2)
    table = F.filter_kmers([(r, 0, 0) for r in reads], 31, stranded=False,
                           min_obs=2)
    chip_smoke.check_table(table, ref)
    counts = np.array(table.counts)
    counts[len(counts) // 2] += 1
    with pytest.raises(chip_smoke.CheckFailed, match="counts"):
        chip_smoke.check_table(dataclasses.replace(table, counts=counts), ref)


def test_compile_cache_follows_env(monkeypatch):
    import jax

    from tpu_debruijn import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(jax.config, "update", _refuse_update)
    assert compile_cache.configure() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def _refuse_update(*args):
    raise AssertionError(f"compile_cache set {args} with the env var set")


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import jax

    from tpu_debruijn import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.configure(".jax_cache_cpu")
        assert path == os.path.join(REPO, ".jax_cache_cpu")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
