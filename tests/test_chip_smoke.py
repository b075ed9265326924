"""chip_smoke.py: refuses to run without a GPU, and its phases (run here
at tiny sizes, with the CPU standing in for the device) pass their own
comparisons and device-path counter checks."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, env_updates):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_updates)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_fails_without_gpu():
    r = _run(ROOT, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def smoke():
    import chip_smoke
    return chip_smoke.Smoke(jax.devices("cpu")[0], quick=True)


@pytest.mark.parametrize("lossless", [True, False])
def test_ht_batch_phase(smoke, lossless):
    rec = smoke.ht_batch("ht", 64, 3, 1, lossless=lossless)
    assert rec["counters"]["enc.fused_ht_frames"] == 3
    assert rec["enc_compile_s"] > 0
    if not lossless:
        assert abs(rec["psnr_gpu_db"][0] - rec["psnr_cpu_db"][0]) <= 0.05


def test_lossy_jp2_phase(smoke):
    rec = smoke.lossy_jp2("jp2", 64)
    assert rec["ratio"] > 5


def test_ebcot_phase_every_backend(smoke):
    recs = smoke.ebcot("eb", 64, 2, 1)
    assert [r["phase"] for r in recs] == ["eb_auto", "eb_native",
                                          "eb_hybrid", "eb_device"]
    assert [r["path"] for r in recs][2:] == ["hybrid", "device"]


@pytest.mark.parametrize("n_devices", [1, 4])
def test_sharded_phase(smoke, n_devices):
    from go_jpeg2000_tpu.parallel import mesh as pmesh
    recs = smoke.sharded16("sh", 128, 64, pmesh.make_mesh(n_devices))
    assert [r["phase"] for r in recs] == ["sh_ht", "sh_ebcot", "sh_budget",
                                          "sh_htlossy"]
    place = recs[0]["placement"]
    assert len({d for d, _ in place["encode_transform_shards"]}) \
        == n_devices
