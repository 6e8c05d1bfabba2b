"""Unit tests for parallel building blocks: halo exchange primitives,
distributed runtime info, scaling harness internals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import PartitionSpec as P
from jax import shard_map

from raymarchdenoiser.parallel.mesh import make_mesh
from raymarchdenoiser.parallel.halo import exchange_rows, exchange_cols, exchange_halo2d
from raymarchdenoiser.parallel.distributed import runtime_info

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")


def _mesh22():
    return make_mesh(4)  # (1, 2, 2)


def test_exchange_rows_matches_global_pad():
    mesh = _mesh22()
    x = jnp.arange(16 * 8, dtype=jnp.float32).reshape(16, 8)
    h = 2

    fn = shard_map(lambda t: exchange_rows(t, h), mesh=mesh,
                   in_specs=P("y", "x"), out_specs=P("y", "x"),
                   check_vma=False)
    out = np.asarray(fn(x))  # (16 + 2h*ny, 8): each shard padded
    # shard (0,0) local tile rows 0..7; its padded top halo must be zeros
    ny = 2
    th = 16 // ny
    blk = th + 2 * h
    np.testing.assert_allclose(out[:h, :4], 0.0)           # top edge zeros
    # shard 0 bottom halo = shard 1 top rows
    np.testing.assert_allclose(out[h + th:blk, :4], np.asarray(x)[th:th + h, :4])


def test_exchange_multihop_rows():
    """halo > local tile extent requires 2-hop exchange."""
    mesh = _mesh22()
    x = jnp.arange(16 * 8, dtype=jnp.float32).reshape(16, 8)
    h = 12  # local tile is 8 rows tall -> needs rows from 2 shards away (zeros)

    fn = shard_map(lambda t: exchange_rows(t, h), mesh=mesh,
                   in_specs=P("y", "x"), out_specs=P("y", "x"),
                   check_vma=False)
    out = np.asarray(fn(x))
    th = 8
    blk = th + 2 * h
    shard0 = out[:blk, :4]
    # top halo: 12 rows, global rows -12..-1 -> all zeros
    np.testing.assert_allclose(shard0[:h], 0.0)
    # center = shard0's own rows
    np.testing.assert_allclose(shard0[h:h + th], np.asarray(x)[:th, :4])
    # bottom halo rows 0..7 = shard1 rows (global 8..15), rest zeros
    np.testing.assert_allclose(shard0[h + th:h + th + 8], np.asarray(x)[8:16, :4])
    np.testing.assert_allclose(shard0[h + th + 8:], 0.0)


def test_exchange_cols_and_2d_shapes():
    mesh = _mesh22()
    x = jnp.ones((16, 16))
    fn = shard_map(lambda t: exchange_halo2d(t, 3), mesh=mesh,
                   in_specs=P("y", "x"), out_specs=P("y", "x"),
                   check_vma=False)
    out = fn(x)
    # each 8x8 shard becomes 14x14 -> global (28, 28)
    assert out.shape == (28, 28)


def test_runtime_info_single_process():
    info = runtime_info()
    assert info["process_count"] == 1
    assert info["global_devices"] >= 1
    assert info["platform"] == jax.default_backend()


def test_filters_wavelet_uses_variance(rng):
    """apply_filter WAVELET: high variance smooths more than near-zero."""
    from raymarchdenoiser.config import FilterParams, FilterType
    from raymarchdenoiser.gbuffer import GBuffer
    from raymarchdenoiser.ops.filters import apply_filter

    H = W = 32
    color = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    g = GBuffer(render=color, albedo=jnp.full((3, H, W), 0.7),
                normal=jnp.zeros((3, H, W)).at[2].set(1.0),
                depth=jnp.full((H, W), 0.5))
    p = FilterParams(type=FilterType.WAVELET, depth=2)
    hi = apply_filter(g, p, variance=jnp.full((H, W), 1.0))
    lo = apply_filter(g, p, variance=jnp.full((H, W), 1e-8))
    assert np.asarray(hi.denoised).std() < np.asarray(lo.denoised).std()


def test_distributed_initialize_before_backend():
    """initialize() must hand off to jax.distributed.initialize BEFORE any
    backend-initializing call (jax.process_count() et al.) — on a real pod a
    late jax.distributed.initialize raises (ADVICE round-1, medium).  Run in
    a subprocess with a fresh, uninitialized jax."""
    import subprocess
    import sys

    prog = r"""
import jax
from jax._src import xla_bridge

calls = {}

def fake_init(**kw):
    calls["kw"] = kw
    calls["backend_initialized_at_call"] = xla_bridge.backends_are_initialized()

jax.distributed.initialize = fake_init

from raymarchdenoiser.parallel import distributed
distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=1,
                       process_id=0)
assert calls, "jax.distributed.initialize was never called"
assert calls["backend_initialized_at_call"] is False, (
    "XLA backend was initialized before jax.distributed.initialize: %r" % calls)
assert calls["kw"]["coordinator_address"] == "127.0.0.1:1"
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=120,
                       cwd="/root/repo")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout


def test_distributed_initialize_idempotent(monkeypatch):
    """A process whose distributed client already exists must not re-init."""
    from raymarchdenoiser.parallel import distributed

    monkeypatch.setattr(distributed, "_distributed_client_active", lambda: True)
    called = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: called.append(kw))
    distributed.initialize(coordinator_address="127.0.0.1:1")
    assert called == []


def test_distributed_initialize_explicit_config_raises(monkeypatch):
    """Explicit coordinator config + failing init must raise, not degrade."""
    from raymarchdenoiser.parallel import distributed

    monkeypatch.setattr(distributed, "_distributed_client_active", lambda: False)

    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        distributed.initialize(coordinator_address="127.0.0.1:1")
