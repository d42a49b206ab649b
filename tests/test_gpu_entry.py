"""The GPU entry points refuse to run without a GPU, and the tests that
need the card.

``chip_smoke.py`` and ``bench.py`` measure or check the GPU; on a
machine without one they must fail and print no result rather than fall
back to the CPU.  Tests marked ``gpu`` run on the card (``python -m
pytest -m gpu``) and skip here; whether there is a card is decided in the
``gpu`` fixture, never at import.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(stdout: str) -> bool:
    return not any(line.strip().startswith("{") for line in
                   stdout.splitlines())


@pytest.mark.parametrize("script,args", [
    ("chip_smoke.py", []), ("chip_smoke.py", ["--four-cards"]),
    ("bench.py", [])])
def test_entry_fails_without_gpu(script, args):
    r = _run([script, *args])
    assert r.returncode != 0
    assert _no_result(r.stdout), r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert _no_result(r.stdout)


def test_require_gpu_exits_on_cpu(capsys):
    from vae_captioning.utils import device
    with pytest.raises(SystemExit) as e:
        device.require_gpu()
    assert e.value.code == 2
    assert "no GPU" in capsys.readouterr().err
    assert device.device_record()["platform"] == "cpu"


def test_nvidia_smi_reports_absence(monkeypatch):
    from vae_captioning.utils import device
    monkeypatch.setattr(device, "NVIDIA_SMI", ["no-such-binary-xyz"])
    assert device.nvidia_smi().startswith("nvidia-smi unavailable")


@pytest.mark.gpu
def test_kernel_compiles_and_matches_reference_on_gpu(gpu):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vae_captioning.ops import logits_topk as lt

    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.normal(size=(4096, 512)), jnp.float32)
    w = jnp.asarray(rng.normal(0, 512 ** -0.5, (512, 11500)), jnp.float32)
    b = jnp.asarray(rng.normal(0, 0.1, (11500,)), jnp.float32)
    for k in (1, 3, 10):
        v, i, l = lt.logits_top_k_pallas(h, w, b, k)
        rv, ri, rl = lt.logits_top_k_xla(h, w, b, k)
        np.testing.assert_allclose(np.asarray(v), np.asarray(rv), atol=1e-3)
        np.testing.assert_allclose(np.asarray(l), np.asarray(rl), atol=1e-3)
        assert float(jnp.mean(i == ri)) > 0.99
    assert json.dumps(jax.devices()[0].platform) == '"gpu"'
