"""Trace reduction (utils/xplane.py): a recorded CPU trace, a synthetic
GPU trace built from a text proto, a live capture, and the CLI."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.profiler import ProfileData

from vae_captioning.utils import xplane

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU_TRACE = os.path.join(DATA, "cpu_trace.xplane.pb")

# one GPU plane: two kernels on a stream (overlapping 3-5 µs), a module
# span without an hlo_op stat; one host plane with an op event
GPU_TRACE = """
planes { id: 1 name: "/device:GPU:0"
  lines { id: 1 name: "Stream #13(Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 5000000
             stats { metadata_id: 1 str_value: "fusion.1" } }
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 4000000
             stats { metadata_id: 1 str_value: "custom-call.2" } }
    events { metadata_id: 1 offset_ps: 12000000 duration_ps: 1000000
             stats { metadata_id: 1 str_value: "fusion.1" } } }
  lines { id: 2 name: "XLA Modules" timestamp_ns: 1000
    events { metadata_id: 3 offset_ps: 0 duration_ps: 13000000 } }
  event_metadata { key: 1 value { id: 1 name: "loop_fusion" } }
  event_metadata { key: 2 value { id: 2 name: "logits_top_k" } }
  event_metadata { key: 3 value { id: 3 name: "jit_step" } }
  stat_metadata { key: 1 value { id: 1 name: "hlo_op" } } }
planes { id: 2 name: "/host:CPU"
  lines { id: 1 name: "python" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 999000000
             stats { metadata_id: 1 str_value: "host_op" } } }
  event_metadata { key: 1 value { id: 1 name: "hostthing" } }
  stat_metadata { key: 1 value { id: 1 name: "hlo_op" } } }
"""


@pytest.fixture()
def gpu_trace(tmp_path):
    path = tmp_path / "gpu.xplane.pb"
    path.write_bytes(ProfileData.text_proto_to_serialized_xspace(GPU_TRACE))
    return str(path)


def test_recorded_cpu_trace_aggregate():
    stats = xplane.aggregate(CPU_TRACE)
    assert list(stats) == ["/host:CPU"]
    ops = {o.name: o for o in stats["/host:CPU"]}
    assert {"dot_general.1", "wrapped_sine", "wrapped_tanh"} <= set(ops)
    assert all(o.count == 3 for o in ops.values())   # three calls traced
    durations = [o.duration_ns for o in stats["/host:CPU"]]
    assert durations == sorted(durations, reverse=True)


def test_recorded_cpu_trace_busy_and_scopes():
    busy, window = xplane.device_busy(CPU_TRACE)
    total = sum(o.duration_ns for o in xplane.aggregate(CPU_TRACE)
                ["/host:CPU"])
    assert 0 < busy <= total and busy <= window
    with open(os.path.join(DATA, "cpu_trace.hlo_op_names.json")) as f:
        names = json.load(f)
    ops = {o.name: o.duration_ns for o in
           xplane.aggregate(CPU_TRACE)["/host:CPU"]}
    got = xplane.scope_times(CPU_TRACE, ["matmul_part", "absent"], names)
    assert got["matmul_part"] == ops["dot_general.1"] + ops["wrapped_sine"]
    assert got["absent"] == 0.0


def test_gpu_trace_counts_device_kernels_only(gpu_trace):
    stats = xplane.aggregate(gpu_trace)
    assert list(stats) == ["/device:GPU:0"]        # host plane dropped
    ops = {o.name: o for o in stats["/device:GPU:0"]}
    assert set(ops) == {"loop_fusion", "logits_top_k"}   # no module span
    assert ops["loop_fusion"].duration_ns == 6000
    assert ops["loop_fusion"].count == 2
    busy, window = xplane.device_busy(gpu_trace)
    assert busy == 8000           # 0-7 µs union + 12-13 µs
    assert window == 13000
    assert xplane.aggregate(gpu_trace, device_only=False).keys() == {
        "/device:GPU:0", "/host:CPU"}


def test_gpu_trace_scope_times_via_hlo_names(gpu_trace):
    names = {"fusion.1": "jit(step)/transpose(jvp(decoder))/lstm/add",
             "custom-call.2": "jit(step)/logits_topk/pallas_call"}
    got = xplane.scope_times(gpu_trace, ["decoder", "logits_topk", "lstm",
                                         "coder"], names)
    assert got == {"decoder": 6000.0, "logits_topk": 4000.0,
                   "lstm": 6000.0, "coder": 0.0}


def test_hlo_op_names_parses_metadata():
    text = """
  %fusion.3 = f32[8]{0} fusion(f32[8]{0} %p), kind=kLoop, metadata={op_name="jit(f)/enc/add" source_file="x.py"}
  ROOT %dot.1 = f32[2,2]{1,0} dot(%a, %b), metadata={op_name="jit(f)/dot_general"}
  %param.0 = f32[8]{0} parameter(0)
"""
    assert xplane.hlo_op_names(text) == {
        "fusion.3": "jit(f)/enc/add", "fusion_3": "jit(f)/enc/add",
        "dot.1": "jit(f)/dot_general", "dot_1": "jit(f)/dot_general"}


def test_aggregate_real_capture(tmp_path):
    """End-to-end: capture a real trace of a jitted op and find op
    events in it."""
    trace_dir = str(tmp_path / "trace")

    @jax.jit
    def f(x):
        return jnp.sin(x) @ x.T

    x = jnp.ones((256, 256))
    np.asarray(f(x))
    with jax.profiler.trace(trace_dir):
        np.asarray(f(x))
    stats = xplane.aggregate(trace_dir)
    assert any(ops for ops in stats.values()), "no op events parsed"
    assert xplane.aggregate(xplane.resolve_trace_path(trace_dir))


def test_cli(gpu_trace, capsys):
    xplane.main([gpu_trace, "--top", "3", "--plane", "GPU"])
    out = capsys.readouterr().out
    assert "logits_top_k" in out and "/device:GPU:0" in out
    assert "busy 0.008 ms of a 0.013 ms window" in out


def test_enable_compile_cache(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing overrides it; without
    it the cache is the fixed checkout directory."""
    from vae_captioning.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        env_dir = tmp_path / "from_env"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(env_dir))
        jax.config.update("jax_compilation_cache_dir", "untouched")
        assert compile_cache.enable_compile_cache() == str(env_dir)
        assert env_dir.is_dir()
        assert jax.config.jax_compilation_cache_dir == "untouched"

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        default = compile_cache.enable_compile_cache()
        assert default == compile_cache.DEFAULT_DIR
        assert default.endswith(".jax_bench_cache")
        assert jax.config.jax_compilation_cache_dir == default
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
