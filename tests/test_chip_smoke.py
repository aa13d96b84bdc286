"""chip_smoke.py rehearsed on the CPU at a tiny size: the same phase
functions the card runs, and the refusal to run without a GPU."""

import importlib.util
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses resolve their module
    spec.loader.exec_module(mod)
    return mod


def test_phases_pass_at_tiny_size(smoke, tmp_path, capsys):
    """Pipeline with planted-structure recovery, cuskss, the CPU-child
    comparisons, the byte-for-byte rerun, the contingency lowering and
    the traced windows, at the rehearsal size. (The `gpu` tests are the
    one phase left out: they skip here and run on the card.)"""
    sz, work, walls = smoke.TINY, str(tmp_path), {}
    smoke.CLOCK.install()
    chr_state = smoke.phase_pipeline(sz, work, 0, walls)
    cmp_state = smoke.phase_prepare_compare(sz, work, 0, chr_state, walls)
    ss = smoke.phase_cuskss(sz, work, 0, walls)
    dev = smoke.phase_compare_device(sz, cmp_state, chr_state, walls)
    smoke.contingency_lowering(sz, chr_state)
    smoke.phase_trace(sz, work, chr_state, ss, walls)
    smoke.phase_compare_check(cmp_state, dev)
    out = capsys.readouterr().out
    assert "planted SNP->trait adjacency" in out
    assert "differing []" in out  # the rerun
    assert "adjacency/sepsets/indices identical" in out
    assert {"cusk-all", "cuskss", "sepselect", "srfci", "mvivw"} <= set(walls)


def test_main_refuses_a_machine_without_gpu(smoke, tmp_path, capsys):
    """No GPU: a non-zero exit and no result line, in either mode."""
    for argv in ([], ["--multichip"]):
        assert smoke.main(argv + ["--workdir", str(tmp_path / "w")]) != 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert not any(ln.startswith("{") and '"ok"' in ln for ln in lines)
        assert lines and "no GPU" in lines[-1]
    assert not os.path.exists(tmp_path / "w")
