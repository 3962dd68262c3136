"""Trace reduction: the device plane is picked by the device's platform."""

import types

import jax

from rad_tpu.utils import profiling


def _event(name, ns):
    return types.SimpleNamespace(name=name, duration_ns=ns)


def test_aggregate_reads_only_the_devices_platform(tmp_path, monkeypatch):
    (tmp_path / "host.xplane.pb").write_bytes(b"")
    ops = types.SimpleNamespace(name="XLA Ops", events=[
        _event("fusion.1", 5), _event("gemm", 7), _event("fusion.1", 1)])
    planes = [
        types.SimpleNamespace(name="/device:GPU:0", lines=[ops]),
        types.SimpleNamespace(name="/device:GPU:1", lines=[
            types.SimpleNamespace(name="XLA Ops",
                                  events=[_event("gemm", 2)])]),
        types.SimpleNamespace(name="/host:CPU", lines=[
            types.SimpleNamespace(name="XLA Ops",
                                  events=[_event("host_op", 100)])]),
    ]
    monkeypatch.setattr(jax.profiler.ProfileData, "from_file",
                        lambda path: types.SimpleNamespace(planes=planes))
    gpu = types.SimpleNamespace(platform="gpu")
    agg, n = profiling.aggregate_xla_ops(str(tmp_path), device=gpu)
    assert agg == {"fusion.1": 6, "gemm": 9} and n == 4
    cpu = types.SimpleNamespace(platform="cpu")
    assert profiling.aggregate_xla_ops(str(tmp_path), device=cpu) == ({}, 0)
