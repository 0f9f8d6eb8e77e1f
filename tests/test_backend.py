"""Device handling: the peaks table, the compile-cache location, backend
selection in the CLIs, and chip_smoke.py's refusal to run without a GPU."""

import os

import pytest

from constraint_solver_tpu.utils import compile_cache
from constraint_solver_tpu.utils.roofline import PEAKS, peaks_for, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_peaks_table_rejects_unknown_devices():
    for kind in ("cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(KeyError):
            peaks_for(kind)


def test_h100_peaks_and_roofline_arithmetic():
    h100 = peaks_for("NVIDIA H100 80GB HBM3")
    assert h100 is PEAKS["NVIDIA H100 80GB HBM3"]
    assert (h100.bf16, h100.tf32, h100.f32, h100.hbm_bw) == (
        989e12, 495e12, 67e12, 3.35e12)
    assert "data sheet" in h100.source
    # 67e12 flops and 3.35e12 bytes per call, 10 calls in 10 s: exactly
    # the f32 and bandwidth peaks.
    r = roofline(67e12, 3.35e12, calls=10, wall_s=10.0, peaks=h100)
    assert r["flops_per_sec"] == 67e12
    assert r["frac_f32"] == 1.0
    assert r["hbm_frac"] == 1.0
    assert r["frac_bf16"] == pytest.approx(67 / 989)
    assert r["frac_tf32"] == pytest.approx(67 / 495)
    assert r["intensity_flops_per_byte"] == pytest.approx(67 / 3.35)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke

    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""  # prints no result line
    assert "no GPU" in out.err


@pytest.mark.parametrize("cli", ["nqueens", "scheduling", "qap", "ackley", "diagram"])
def test_cli_rejects_platform_tpu(cli, capsys):
    import importlib

    mod = importlib.import_module(f"constraint_solver_tpu.cli.{cli}")
    with pytest.raises(SystemExit) as exc:
        mod.main(["--platform", "tpu"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_platform_gpu_fails_without_gpu():
    import jax

    from constraint_solver_tpu.utils import backend

    saved = jax.config.jax_platforms
    try:
        with pytest.raises(RuntimeError):
            backend.init("gpu")
    finally:
        jax.config.update("jax_platforms", saved)
    assert jax.devices()[0].platform == "cpu"
