"""bench.py: one metric line, last on stdout, for the fastest batch.

``main`` runs here with the GPU check and the decode timing stubbed
(the model, trainer and decode functions are built for real, at a small
vocabulary); that bench.py refuses to run without a GPU is in
tests/test_gpu_entry.py."""

import json

import pytest

import bench


def test_metric_line_fields():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    d = json.loads(bench.metric_line("m", 123.5, dev, 4096))
    assert d == {"metric": "m", "value": 123.5,
                 "unit": "captions/sec/chip", "device": dev, "batch": 4096}


@pytest.fixture()
def stubbed(monkeypatch):
    from vae_captioning.utils import device
    dev = {"platform": "gpu", "kind": "stub", "count": 2}
    monkeypatch.setattr(device, "require_gpu", lambda: dev)
    monkeypatch.setattr(device, "nvidia_smi", lambda: "stub, 700.00 W")
    calls = []

    def fake_time(beam_fn, params, features, c_v, iters):
        calls.append((features.shape[0], iters))
        return {8: 0.01, 16: 0.01, 32: 0.05}[features.shape[0]], 0.0
    monkeypatch.setattr(bench, "_time_decode", fake_time)
    return calls


def test_main_prints_fastest_batch_last(stubbed, capsys):
    bench.main(["--batches", "8", "16", "32", "--vocab", "64",
                "--iters", "2"])
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    d = json.loads(lines[-1])
    assert d["metric"] == "captions_per_sec_per_chip_beam3"
    assert d["batch"] == 16
    assert d["value"] == pytest.approx(16 / 0.01 / 2)
    assert d["device"]["kind"] == "stub"
    assert stubbed == [(8, 2), (16, 2), (32, 2)]
    assert "stub, 700.00 W" in out.err


def test_main_trained_metric_name(stubbed, capsys):
    bench.main(["--batches", "8", "--vocab", "64", "--trained", "2"])
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["metric"] == "captions_per_sec_per_chip_beam3_trained"


def test_time_decode_blocks_on_results():
    """Each timed call ends in block_until_ready: the median is over
    completed calls and setup is the first (compiling) call."""
    import jax
    import jax.numpy as jnp

    seen = []

    def fn(params, features, c_v, key):
        seen.append(key)
        return jnp.sum(features) + params, jnp.zeros(())

    dt, setup = bench._time_decode(jax.jit(fn), 1.0, jnp.ones((4, 3)),
                                   None, iters=3)
    assert len(seen) >= 1 and dt >= 0.0 and setup >= 0.0
