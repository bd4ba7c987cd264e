"""The port's scale-out (svscope_tpu_torch/parallel, the dp hooks, the
read-parallel EM, the multi-process window stream and the dry run) against
the JAX package's on the CPU.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port on
("cpu",) * n device tuples.  Records, MSAs, K and labels must be identical;
the read-parallel EM's BICs agree with JAX's within rtol 1e-9 in float64
and 1e-5 in float32 (JAX's draws fed to both; the shards' partial sums add
in another order).  Every test that installs a mesh, the port's or
JAX's, clears it in `finally`.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svscope_tpu.models.mixture as jmx
import svscope_tpu_torch.models.mixture as tmx
from svscope_tpu.engine import localgraph as jlg
from svscope_tpu.parallel import dataparallel as jdp
from svscope_tpu.parallel.shard import shard_records as jax_shard_records
from svscope_tpu_torch import graft_entry
from svscope_tpu_torch.engine import localgraph as tlg
from svscope_tpu_torch.engine.datamaker import WindowData
from svscope_tpu_torch.ops import poa_align
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops.poa_batch import poa_msa_batch
from svscope_tpu_torch.parallel import dataparallel as dpm
from svscope_tpu_torch.parallel import shard as tshard
from svscope_tpu_torch.tools import multihost_demo

import bench
import torch_workloads as tw
from test_torch_mixture import jax_uniforms

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpus(n):
    return ("cpu",) * n


@pytest.mark.parametrize("n,count,block", [(100, 4, 8), (37, 3, 16),
                                           (5, 2, 16), (64, 1, 4)])
def test_shard_records_matches_jax(n, count, block):
    recs = [f"chr1\t{i}\t{i + 10}" for i in range(n)]
    parts = [tshard.shard_records(recs, p, count, block)
             for p in range(count)]
    assert parts == [jax_shard_records(recs, p, count, block)
                     for p in range(count)]
    assert sorted(sum(parts, [])) == sorted(recs)


def _dryrun_windows(make):
    """The dry run's batch: 24 bench windows and 8 windows cut to 10 reads
    (a second read bucket)."""
    wins = make(24, np.random.default_rng(11))
    for w in make(8, np.random.default_rng(12)):
        keep = list(range(5)) + list(range(12, 17))
        wins.append(type(w)([w.sequences[0]]
                            + [w.sequences[1 + i] for i in keep],
                            w.read_ids[keep], w.flank_5, w.flank_3,
                            w.record, w.flag))
    return wins


@pytest.fixture(scope="module")
def dp_windows():
    wins = _dryrun_windows(tw.make_window_payloads)
    assert all(isinstance(w, WindowData) for w in wins)
    base = tlg.process_window_batch(wins, device="cpu")
    return wins, base


@pytest.fixture(scope="module")
def jax_dp_records():
    """JAX's dp run of the dry run's batch, by mesh size."""
    wins = _dryrun_windows(bench.make_window_payloads)
    cache = {}

    def get(n):
        if n not in cache:
            try:
                jdp.set_data_mesh(jdp.make_dp_mesh(n))
                cache[n] = jlg.process_window_batch(wins, device_poa=False)
                assert jdp.LAST_DISPATCH["n_shards"] == n
            finally:
                jdp.set_data_mesh(None)
        return cache[n]
    return get


@pytest.mark.parametrize("n,device_poa", [(2, False), (4, False), (8, False),
                                          (2, True)])
def test_dp_process_window_batch(dp_windows, jax_dp_records, n, device_poa):
    """dp records == the port's unsharded run == JAX's dp run, with the EM
    (and, with device_poa, K1's per-round batches: the plain K1 on the
    CPU, so only the 8 short windows) split over the mesh.  A window's
    record does not depend on the batch around it."""
    wins, base = dp_windows
    part = slice(24, None) if device_poa else slice(None)
    before = poa_align.LAUNCHES
    try:
        dpm.set_data_mesh(cpus(n))
        got = tlg.process_window_batch(wins[part], device="cpu",
                                       device_poa=device_poa)
        assert dpm.LAST_DISPATCH == {"sharded": True, "n_shards": n}
    finally:
        dpm.set_data_mesh(None)
    assert poa_align.LAUNCHES == before        # CPU tensors: plain version
    assert got == base[part]
    assert got == jax_dp_records(n)[part]


@pytest.mark.parametrize("n", [2, 8, 3])
def test_dp_fused_msa_matches_host(n):
    """The dry run's 8 small windows through the fused build split over the
    mesh == the host engine; a chunk the mesh does not divide (n=3) runs
    whole on the first device, and LAST_DISPATCH says so."""
    rng = np.random.default_rng(5)
    fwins = []
    for _ in range(8):
        ref = "".join(rng.choice(list("ACGT"), 48))
        ins = "".join(rng.choice(list("ACGT"), 6))
        fwins.append([ref] + [ref[:24] + ins + ref[24:] if i % 2 else ref
                              for i in range(4)])
    want = poa_msa_batch(fwins, use_device=False, device="cpu")
    tpf.reset_counts()
    try:
        dpm.set_data_mesh(cpus(n))
        got = poa_msa_batch(fwins, use_device="fused", device="cpu")
        assert dpm.LAST_DISPATCH["sharded"] == (8 % n == 0)
        assert dpm.LAST_DISPATCH["n_shards"] == (n if 8 % n == 0 else 1)
    finally:
        dpm.set_data_mesh(None)
    assert got == want
    assert tpf.COUNTS["fallbacks"] == 0


def _two_cluster_window(rng, n1, n2, nf):
    a = rng.integers(0, 4, (1, nf))
    b = (a + 1 + rng.integers(0, 3, (1, nf))) % 4
    x = np.concatenate([np.repeat(a, n1, 0), np.repeat(b, n2, 0)])
    flip = rng.random(x.shape) < 0.03
    return np.where(flip, rng.integers(0, 5, x.shape), x).astype(np.int8)


@pytest.mark.parametrize("labels_only", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mp_em_matches_jax_and_unsharded(dtype, labels_only):
    """Read-parallel EM: the 500-read (selection cap) and 300-read windows
    (the dry run's among them) scatter their read axis over 8 devices, a
    small window stays on the batch path.  K and labels == the port's unsharded run == JAX's mp run;
    BICs == JAX's and the unsharded run's within rtol 1e-9 (float64;
    measured 1.2e-15) / 1e-5 (float32; measured 1.9e-6)."""
    jdt, tdt, rtol = {"float64": (jnp.float64, torch.float64, 1e-9),
                      "float32": (jnp.float32, torch.float32, 1e-5)}[dtype]
    rng = np.random.default_rng(5)
    feats = [_two_cluster_window(rng, 250, 250, 40),
             _two_cluster_window(rng, 6, 6, 18),
             _two_cluster_window(rng, 150, 150, 64),
             # the dry run's (0a) window
             _two_cluster_window(np.random.default_rng(7), 150, 150, 32)]
    run = lambda: tmx.em_cluster_batch_dispatch(
        feats, labels_only=labels_only, dtype=tdt, device="cpu",
        uniforms=jax_uniforms)()
    base = run()
    assert not tmx.LAST_MP_DISPATCH["used"]
    try:
        dpm.set_data_mesh(cpus(8))
        got = run()
        assert tmx.LAST_MP_DISPATCH == {"used": True, "n_shards": 8,
                                        "n_windows": 3}
    finally:
        dpm.set_data_mesh(None)
    try:
        jdp.set_data_mesh(jdp.make_dp_mesh(8))
        want = jmx.em_cluster_batch_dispatch(feats, labels_only=labels_only,
                                             dtype=jdt)()
        assert jmx.LAST_MP_DISPATCH["n_windows"] == 3
    finally:
        jdp.set_data_mesh(None)
    for b, g, w in zip(base, got, want):
        assert g[0] == b[0] == w[0]                        # K
        assert (g[2] == b[2]).all() and (g[2] == w[2]).all()  # labels
        np.testing.assert_allclose(g[6], w[6], rtol=rtol)
        np.testing.assert_allclose(g[6], b[6], rtol=rtol)


@pytest.mark.parametrize("n", [2, 4])
def test_em_windows_and_reads_split_matches_jax(n):
    """The dry run's (1): one dispatch over (windows x reads), 8 small
    windows (a 32-slot chunk, window axis split) and two 300-read windows
    (read axis split).  K and labels == the port's unsharded run == JAX's
    run under its dp mesh; BICs within rtol 1e-9 (float64, JAX's draws fed
    to both; in float32 an ulp flips a 12-read window's K=7 restart run,
    ROADMAP Queue C 6)."""
    rng = np.random.default_rng(8)
    feats = [_two_cluster_window(rng, 6, 6, 20) for _ in range(8)]
    feats[3:3] = [_two_cluster_window(rng, 150, 150, 24)]
    feats.append(_two_cluster_window(rng, 150, 150, 40))
    run = lambda: tmx.em_cluster_batch_dispatch(
        feats, labels_only=True, dtype=torch.float64, device="cpu",
        uniforms=jax_uniforms)()
    base = run()
    try:
        dpm.set_data_mesh(cpus(n))
        got = run()
        assert dpm.LAST_DISPATCH == {"sharded": True, "n_shards": n}
        assert tmx.LAST_MP_DISPATCH == {"used": True, "n_shards": n,
                                        "n_windows": 2}
    finally:
        dpm.set_data_mesh(None)
    try:
        jdp.set_data_mesh(jdp.make_dp_mesh(n))
        want = jmx.em_cluster_batch_dispatch(feats, labels_only=True,
                                             dtype=jnp.float64)()
        assert jmx.LAST_MP_DISPATCH["n_windows"] == 2
    finally:
        jdp.set_data_mesh(None)
    for b, g, w in zip(base, got, want):
        assert g[0] == b[0] == w[0]
        assert (g[2] == b[2]).all() and (g[2] == w[2]).all()
        assert np.isfinite(g[6]).all()
        np.testing.assert_allclose(g[6], w[6], rtol=1e-9)
        np.testing.assert_allclose(g[6], b[6], rtol=1e-9)


def test_mp_route_needs_divisible_read_bucket():
    x = np.zeros((300, 12), np.int8)
    assert tmx._mp_route([x], cpus(8)) == {0}
    assert tmx._mp_route([x], cpus(3)) == set()          # 512 % 3
    assert tmx._mp_route([x], cpus(1)) == set()
    assert tmx._mp_route([x[:256]], cpus(8)) == set()    # not above 256


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pair"))
    ref, tumor, normal, recs, _ = tw.make_test_pair(d, seed=4)
    single = tlg.run_local_graph(recs, ref, [tumor], [normal], ["S"], ["S"],
                                 os.path.join(d, "single"), offset=50,
                                 device="cpu")
    with open(single) as f:
        return d, ref, tumor, normal, recs, f.read()


def test_run_local_graph_data_parallel_cleared_after(pair):
    d, ref, tumor, normal, recs, want = pair
    out = tlg.run_local_graph(recs, ref, [tumor], [normal], ["S"], ["S"],
                              os.path.join(d, "dp"), offset=50,
                              device="cpu", data_parallel=cpus(2))
    assert dpm.data_mesh() is None
    with open(out) as f:
        assert f.read() == want


def test_run_local_graph_data_parallel_off_by_default(pair, monkeypatch):
    """With data_parallel left at None no mesh is installed, even where
    several CUDA devices are present (here pretended: the run itself is
    replaced by a probe of the installed mesh)."""
    d, ref, tumor, normal, recs, _want = pair
    seen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tlg, "resolve_device",
                        lambda name: torch.device("cuda", 0))
    monkeypatch.setattr(tlg, "_run_local_graph",
                        lambda *a, **k: seen.append(dpm.data_mesh()))
    tlg.run_local_graph(recs, ref, [tumor], [normal], ["S"], ["S"],
                        os.path.join(d, "default"), offset=50)
    assert seen == [None]


def test_sharded_local_graph_matches_single(pair):
    """Two processes simulated in sequence (test_parallel.py's model)."""
    d, ref, tumor, normal, recs, want = pair
    shard_dir = os.path.join(d, "sharded")
    assert tshard.run_local_graph_sharded(
        recs, ref, [tumor], [normal], ["S"], ["S"], shard_dir,
        process_index=1, process_count=2, merge=False, offset=50,
        device="cpu") is None
    out = tshard.run_local_graph_sharded(
        recs, ref, [tumor], [normal], ["S"], ["S"], shard_dir,
        process_index=0, process_count=2, merge=True, offset=50,
        device="cpu")
    with open(out) as f:
        assert f.read() == want


def test_real_gloo_two_processes(pair):
    """Two OS processes of tools/dist_worker.py joined through a gloo
    rendezvous (a file in the run directory), each on the CPU; process 0's
    merged Raw.bed == the single run's."""
    d, ref, tumor, normal, recs, want = pair
    wb = os.path.join(d, "windows.bed")
    with open(wb, "w") as f:
        f.write("\n".join(recs) + "\n")
    dist_dir = os.path.join(d, "dist")
    res = multihost_demo.launch_workers(
        2, f"file://{d}/rendezvous", ref, tumor, normal, wb, dist_dir,
        ["cpu", "cpu"], threads=1)
    for rc, out in res:
        assert rc == 0, out[-3000:]
    with open(os.path.join(dist_dir, "S.vs.S.TandemRepeat.Raw.bed")) as f:
        assert f.read() == want


def test_dist_worker_env_appends_pythonpath(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    parts = multihost_demo.worker_env()["PYTHONPATH"].split(os.pathsep)
    assert parts == [REPO, "/elsewhere"]


def test_init_distributed_without_coordinator():
    assert tshard.init_distributed() == (0, 1)


def test_graft_dryrun_four_cpu_devices():
    graft_entry.dryrun_multichip(4, devices=cpus(4))
    assert dpm.data_mesh() is None


def test_graft_entry_forward_cpu():
    fn, args = graft_entry.entry("cpu")
    bics, gammas = fn(*args)
    assert tuple(bics.shape) == (16, 9)
    assert tuple(gammas.shape) == (16, 9, 32, 9)
    assert torch.isfinite(bics).all()


def test_make_dp_mesh_takes_given_devices():
    """Repeats allowed; without devices it takes CUDA's or raises
    (tests/test_torch_defaults.py)."""
    assert dpm.make_dp_mesh(devices=cpus(3)) == (torch.device("cpu"),) * 3
    assert dpm.make_dp_mesh(2, devices=cpus(2)) == (torch.device("cpu"),) * 2


def test_shard_batch_splits_in_order():
    a = np.arange(8)
    b = np.arange(16).reshape(8, 2)
    try:
        dpm.set_data_mesh(cpus(4))
        parts = dpm.shard_batch((a, b))
        assert [len(p[1][0]) for p in parts] == [2] * 4
        assert np.array_equal(np.concatenate([p[1][1] for p in parts]), b)
        assert len(dpm.shard_batch((a[:6], b[:6]))) == 1   # 6 % 4
        assert len(dpm.shard_batch((a, b), min_per_shard=4)) == 1
    finally:
        dpm.set_data_mesh(None)
    assert dpm.shard_batch((a, b), device="cpu")[0][1][0] is a
