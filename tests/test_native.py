"""Native bedops library vs numpy reference implementations."""

import numpy as np
import pytest

from cigwas_tpu.io.bed import decode_bed_values, encode_bed_values
from cigwas_tpu.native import bed_col_stats, bed_decode, get_lib
from cigwas_tpu.prep import compute_bed_stats

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="native library unavailable (no toolchain)"
)


@pytest.fixture(scope="module")
def geno():
    rng = np.random.default_rng(9)
    g = rng.integers(0, 3, size=(25, 103)).astype(np.float32)
    g[rng.random(g.shape) < 0.07] = np.nan
    return g, encode_bed_values(g)


def test_native_decode_matches_numpy(geno):
    g, bb = geno
    n = g.shape[1]
    nv, nva = bed_decode(bb, n)
    pv, pva = decode_bed_values(bb, n)
    assert np.array_equal(nv, pv)
    assert np.array_equal(nva, pva)


def test_native_col_stats_match_numpy(geno):
    g, bb = geno
    n = g.shape[1]
    nm, ns, nmo = bed_col_stats(bb, n)
    pm, ps, pmo = compute_bed_stats(bb, n)
    assert np.allclose(nm, pm, atol=1e-6)
    assert np.allclose(ns, ps, atol=1e-6)
    assert np.array_equal(nmo, pmo)


def test_native_file_stats_golden(tmp_path):
    """Whole-file streamed pass reproduces the prep golden fixture."""
    import os
    import shutil

    from cigwas_tpu.native import bed_file_col_stats

    data = os.path.join(os.path.dirname(__file__), "data", "test_files")
    res = bed_file_col_stats(os.path.join(data, "small.bed"), 10, 5)
    assert res is not None
    means, stds, modes = res
    assert np.allclose(means, [0.6, 1.1, 0.8, 1.0, 0.9], atol=1e-6)
    assert np.allclose(
        stds, [0.66332496, 0.83066239, 0.6, 0.77459667, 0.83066239], atol=1e-6
    )


def test_library_name_tracks_source_content(tmp_path, monkeypatch):
    """The cached library is keyed by the source's content, not by file
    times a checkout scrambles: an edited source gets a new library path,
    restoring it gives the old one back."""
    from cigwas_tpu import native

    src = tmp_path / "bedops.cpp"
    src.write_text("int f() { return 1; }\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    first = native._so_path()
    src.write_text("int f() { return 2; }\n")
    assert native._so_path() != first
    src.write_text("int f() { return 1; }\n")
    assert native._so_path() == first
