"""What the program needs from the accelerator it runs on: full-precision
float32 selection dots and a fixed place for the compile cache."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lowered_level_scan_minrho():
    from cigwas_tpu.ops import pcorr

    nt, d, K = 4, 16, 8
    i32 = jnp.int32
    return pcorr.level_scan_minrho.lower(
        jnp.zeros((64, 64)), jnp.zeros(nt, i32), jnp.zeros((nt, d), i32),
        jnp.zeros(nt, i32), jnp.zeros((2, K, 2), i32), jnp.zeros((2, nt), i32),
        l=2,
    )


def _lowered_level_scan_hetcor():
    from cigwas_tpu.ops import pcorr

    nt, d, K = 4, 16, 8
    i32 = jnp.int32
    return pcorr.level_scan_hetcor.lower(
        jnp.zeros((64, 64)), jnp.zeros((64, 64)), jnp.zeros(64, i32),
        jnp.zeros(nt, i32), jnp.zeros((nt, d), i32), jnp.zeros(nt, i32),
        jnp.zeros((2, K, 3), i32), jnp.zeros((2, nt), i32), jnp.float32(1.0),
        l=3,
    )


def _lowered_spmd_step():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cigwas_tpu.parallel import build_multichip_cusk_step, make_mesh

    mesh = make_mesh(8, block=2, marker=2, sample=2)
    step = build_multichip_cusk_step(mesh, 3.0, 3.0)
    codes = jax.device_put(np.zeros((2, 16, 64), np.int32),
                           NamedSharding(mesh, P("block", "marker", "sample")))
    phen = jax.device_put(np.zeros((2, 2, 64), np.float32),
                          NamedSharding(mesh, P("block", None, "sample")))
    return step.lower(codes, phen)


def _lowered_graft_step():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(REPO)
    fn, args = graft.entry()
    return jax.jit(fn).lower(*args)


@pytest.mark.parametrize("lowered", [
    _lowered_level_scan_minrho, _lowered_level_scan_hetcor,
    _lowered_spmd_step, _lowered_graft_step,
])
def test_f32_dots_pinned_to_highest(lowered):
    """Every float32 dot_general of the level and hetcor kernels (and of
    the multi-device and single-step entry points) carries HIGHEST
    precision: on a GPU the default may run in TF32 and round the one-hot
    selected correlations and ESS values."""
    dots = [ln for ln in lowered().as_text().splitlines()
            if "stablehlo.dot_general" in ln]
    f32 = [ln for ln in dots if re.search(r"tensor<[^>]*xf32>", ln)]
    assert f32, "no float32 dot found"
    loose = [ln.strip() for ln in f32 if "HIGHEST, HIGHEST" not in ln]
    assert not loose, loose


def _cache_dir(env_extra: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c",
         "import cigwas_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, check=True, cwd="/",
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env_var(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_compile_cache_defaults_to_fixed_checkout_path():
    import cigwas_tpu

    got = _cache_dir({})
    assert got == os.path.join(REPO, ".jax_cache")
    assert got == cigwas_tpu.DEFAULT_COMPILE_CACHE_DIR
    assert _cache_dir({}) == got  # no temp name, pid or time in the path
