"""The device chooser (hla_la_tpu/device.py) and the device-path rules
around it: NW choice per platform, batch buckets, compile-cache
placement, full-precision matmuls, one process per device, host NW for
long-read shapes, the native library's build key, and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hla_la_tpu import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("L,W", [(128, 32), (256, 32), (64, 8)])
def test_nw_forward_choice(L, W):
    """The XLA scan serves every shape, cached per (L, W)."""
    fwd = device.nw_forward(L, W)
    assert fwd.__wrapped__.__qualname__ == "make_jax_banded_nw.<locals>.forward"
    assert device.nw_forward(L, W) is fwd


@pytest.mark.parametrize("n,platform,want", [
    (1, "cpu", 64), (100, "cpu", 128), (70000, "cpu", 131072),
    (1, "gpu", 4096), (4096, "gpu", 4096)])
def test_batch_bucket(n, platform, want):
    assert device.batch_bucket(n, platform) == want


def test_batch_bucket_refuses_unsliced_device_batch():
    with pytest.raises(AssertionError):
        device.batch_bucket(device.DEVICE_BATCH + 1, "gpu")


@pytest.mark.parametrize("platform,want", [
    ("cpu", device.HOST_MAX_BATCH), ("gpu", device.DEVICE_BATCH)])
def test_max_batch(platform, want):
    assert device.max_batch(platform) == want
    assert device.batch_bucket(want, platform) == want


@pytest.mark.parametrize("env", [None, "/some/shared/jax-cache"])
def test_compile_cache_placement(monkeypatch, env):
    before = jax.config.jax_compilation_cache_dir
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    try:
        got = device.setup_compile_cache()
        if env is None:
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            assert got == env
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_line_names_the_device():
    line = device.device_line()
    d = jax.devices()[0]
    assert f"platform={d.platform}" in line
    assert f"kind={d.device_kind}" in line
    assert f"count={len(jax.devices())}" in line


@pytest.mark.parametrize("backend,want", [
    ("jax", 1), ("sharded", 1), ("auto", 4), ("numpy", 4)])
def test_host_workers(backend, want):
    from hla_la_tpu.models.pipeline import host_workers
    from hla_la_tpu.utils.config import RunConfig
    assert host_workers(RunConfig(max_threads=4), backend) == want


def _spy_dot(monkeypatch):
    seen = []
    real = jnp.dot

    def spy(*a, **kw):
        seen.append(kw.get("precision"))
        return real(*a, **kw)
    monkeypatch.setattr(jnp, "dot", spy)
    return seen


def _cluster_ll(rng):
    from hla_la_tpu.ops.pair_ll import cluster_read_ll
    cluster_read_ll(np.ones((3, 5, 6), np.float32),
                    rng.normal(size=(7, 5, 6)).astype(np.float32),
                    np.zeros((7, 5, 6), np.float32), backend="jax")


def _mesh_typing(rng):
    from hla_la_tpu.parallel.mesh import make_mesh, sharded_typing_step
    sharded_typing_step(make_mesh(1))(
        np.ones((5, 9), np.float32), np.ones((11, 9), np.float32))


def _mesh_full_step(rng):
    from hla_la_tpu.parallel.mesh import full_step, make_mesh
    full_step(make_mesh(1), 16, 8)(
        np.zeros((4, 16), np.uint8), np.full(4, 16), np.zeros((4, 24),
                                                              np.uint8),
        np.ones((6, 9), np.float32), np.ones((13, 9), np.float32))


def _graft_entry(rng):
    sys.path.insert(0, REPO)
    from __graft_entry__ import entry
    fn, args = entry()
    jax.jit(fn).trace(*args)


@pytest.mark.parametrize("site", [_cluster_ll, _mesh_typing,
                                  _mesh_full_step, _graft_entry])
def test_matmuls_request_highest_precision(monkeypatch, rng, site):
    seen = _spy_dot(monkeypatch)
    site(rng)
    assert seen and all(p == jax.lax.Precision.HIGHEST for p in seen)


def test_native_build_key_follows_cpu(monkeypatch):
    from hla_la_tpu import native
    nd = os.path.join(REPO, "native")
    monkeypatch.setattr(native, "_cpu_signature", lambda: "cpu one")
    a = native._lib_path(nd)
    assert a == native._lib_path(nd)
    assert a.startswith(os.path.join(nd, "build") + os.sep)
    monkeypatch.setattr(native, "_cpu_signature", lambda: "cpu two")
    assert native._lib_path(nd) != a


def _tiny_package(tmp_path, rng):
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    sim = simulate_prg_package(rng, backbone_length=1200, n_haplotypes=3)
    return sim, sim.write_package(str(tmp_path / "g"))


@pytest.mark.parametrize("L,W", [(512, 32), (64, 256)])
def test_long_read_shape_takes_host_nw(tmp_path, rng, capsys, L, W):
    from hla_la_tpu.models.aligner import ReadAligner
    from hla_la_tpu.ops.banded_nw import banded_nw_forward
    _, pkg = _tiny_package(tmp_path, rng)
    al = ReadAligner(pkg, use_jax=True, band=W)
    B = 5
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    lens = np.full(B, L - 3, np.int64)
    got = al._run_nw(reads, lens, refs)
    al._run_nw(reads, lens, refs)
    want = banded_nw_forward(reads, lens, refs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    err = capsys.readouterr().err
    assert err.count(f"NW shape L={L} W={W} is a long-read shape") == 1


def test_device_backend_starts_no_workers(tmp_path, rng, monkeypatch):
    """--maxThreads > 1 under a device backend: no alignment pool and no
    typing fan-out; the run says so."""
    from hla_la_tpu.models import parallel_host, pipeline, typer
    from hla_la_tpu.sim.read_sim import ReadSimulator
    from hla_la_tpu.utils.config import RunConfig

    def boom(*a, **kw):
        raise AssertionError("a worker pool was started")
    monkeypatch.setattr(parallel_host, "ParallelAligner", boom)
    monkeypatch.setattr(typer.HLATyper, "_type_loci_parallel", boom)
    sim, pkg = _tiny_package(tmp_path, rng)
    rs = ReadSimulator(rng, read_length=90, fragment_mean=300,
                       fragment_sd=25)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 40.0,
                                               name_prefix=f"h{h}")
    assert len(pairs) > 512
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    logs = []
    monkeypatch.setattr(pipeline, "log_progress", logs.append)
    res = pipeline.run_hla_typing(pkg, pairs=fq,
                                  output_dir=str(tmp_path / "out"),
                                  cfg=RunConfig(max_threads=4),
                                  backend="jax")
    assert res.results
    assert any("no worker processes" in m for m in logs)


def test_chip_smoke_refuses_cpu():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_refuses_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path),
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
