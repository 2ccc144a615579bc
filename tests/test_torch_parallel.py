"""Port parity: the multi-device layer (parallel/mesh.py's mesh, shards and
sharded step; ``Pipeline(device=[...])``; parallel/multihost.py on
torch.distributed).

On the CPU a mesh is a grid of "cpu" devices: the sharded step must equal
the port's one-device ``experiment_step`` and the JAX package's
``experiment_step_sharded`` on conftest's 8 host devices (integers
exactly, floats at tests/test_torch_step.py's tolerances). The multihost
functions run in two real processes joined over gloo; every CSV they write
must be byte-identical to a single process's ``Pipeline`` run on all the
data. Each child process has its own timeout, so nothing here can hang the
suite. Run as a script, this file is that child process:
``python tests/test_torch_parallel.py <mode> <rank> <nproc> <port> <dir>``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

STEP = dict(max_candidates=64, num_iters=20, upsample_factor=5)
CHILD_TIMEOUT_S = 60


def _experiment_stack():
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_experiment_stack)
    return make_experiment_stack(4, 3, 96, 96, spots_per_field=25, seed=2)


def _config():
    from fluorosequencingimageanalysis_torch.config import (
        DetectConfig, PipelineConfig, RegistrationConfig)
    return PipelineConfig(detect=DetectConfig(max_candidates=128,
                                              num_iters=20),
                          registration=RegistrationConfig(upsample_factor=5))


def _movie():
    from multihost_worker import synthetic_movie
    return synthetic_movie(T=12, H=64, W=64)


def _frames():
    from fluorosequencingimageanalysis_torch.utils.synth import make_zstack
    return make_zstack(6, 64, 64, n_spots=20)


TT_KW = dict(search_radius=3, s_n_cutoff=3.0, mirror_start=3,
             chung_kennedy=1, p_threshold=0.01)


# -- the mesh and the sharded step -------------------------------------------

@pytest.mark.parametrize("args,kw", [
    ((), {}), ((8,), {}), ((8,), dict(model_axis=2)),
    ((8,), dict(data_axis=4)), ((4,), dict(data_axis=2, model_axis=2)),
    ((6,), dict(model_axis=3)), ((1,), {})])
def test_make_mesh_follows_the_jax_axis_rules(args, kw):
    from fluorosequencingimageanalysis_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from fluorosequencingimageanalysis_torch.parallel.mesh import make_mesh
    want = jax_make_mesh(*args, **kw)
    got = make_mesh(*args, devices=["cpu"] * 8, **kw)
    assert got.axis_names == tuple(want.axis_names) == ("data", "model")
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_make_mesh_raises_as_the_jax_function_does(monkeypatch):
    from fluorosequencingimageanalysis_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    from fluorosequencingimageanalysis_torch.parallel.mesh import make_mesh
    for kw in (dict(data_axis=3), dict(model_axis=3),
               dict(data_axis=2, model_axis=2)):
        with pytest.raises(ValueError, match="must equal n_devices"):
            jax_make_mesh(8, **kw)
        with pytest.raises(ValueError, match="must equal n_devices"):
            make_mesh(8, devices=["cpu"] * 8, **kw)
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(3, devices=["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


def test_shard_fields_splits_the_fields_axis_on_data():
    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        make_mesh, shard_fields)
    stack = np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3)
    shards = shard_fields(stack, make_mesh(devices=["cpu"] * 8,
                                           data_axis=4))
    assert len(shards) == 4
    np.testing.assert_array_equal(np.concatenate([s.numpy() for s in
                                                  shards]), stack)
    with pytest.raises(ValueError, match="do not split"):
        shard_fields(stack[:7], make_mesh(devices=["cpu"] * 2))


@pytest.fixture(scope="module")
def step_stack():
    from multihost_worker import synthetic_stack
    stack = synthetic_stack(F=8, C=2)
    stack[3, 1] = np.roll(stack[3, 1], (1, -2), axis=(0, 1))
    return stack


@pytest.fixture(scope="module")
def one_device_step(step_stack):
    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        experiment_step)
    with torch.no_grad():
        out = experiment_step(torch.from_numpy(step_stack), **STEP)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("n,data_axis", [(2, None), (8, None), (8, 4)])
def test_sharded_step_equals_the_one_device_step(step_stack, one_device_step,
                                                 n, data_axis):
    """2 and 8 data shards, and 4 data x 2 model (detection split over
    the model devices); integers exactly, floats at the step tolerances."""
    from test_torch_step import _assert_step_parity

    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        experiment_step_sharded, make_mesh)
    torch.set_num_threads(1)
    mesh = make_mesh(devices=["cpu"] * n, data_axis=data_axis)
    out = experiment_step_sharded(step_stack, mesh, **STEP)
    got = {k: v.numpy() for k, v in out.items()}
    assert set(got) == set(one_device_step)
    for k, v in one_device_step.items():
        assert got[k].dtype == v.dtype, k
    _assert_step_parity(got, one_device_step)


def test_sharded_step_equals_the_jax_sharded_step(step_stack,
                                                   one_device_step):
    """The JAX package's experiment_step_sharded on make_mesh(8) (conftest's
    8 host devices) against the port's on an 8-entry CPU mesh."""
    import jax.numpy as jnp

    from test_torch_step import _assert_step_parity

    from fluorosequencingimageanalysis_tpu.parallel.mesh import (
        experiment_step_sharded as jax_sharded, make_mesh as jax_make_mesh)
    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        experiment_step_sharded, make_mesh)
    torch.set_num_threads(1)
    want = {k: np.asarray(v) for k, v in jax_sharded(
        jnp.asarray(step_stack), jax_make_mesh(8), **STEP).items()}
    out = experiment_step_sharded(step_stack,
                                  make_mesh(devices=["cpu"] * 8), **STEP)
    _assert_step_parity({k: v.numpy() for k, v in out.items()}, want)


def test_pipeline_over_a_device_list_pads_and_raises_elsewhere(tmp_path):
    """3 fields on 2 data shards: run_stack pads to 4 and drops the
    padding; run_experiment's rows and CSV equal the one-device
    Pipeline's; methods that do not shard raise NotImplementedError
    naming the ROADMAP item."""
    from fluorosequencingimageanalysis_torch.api import (
        MULTI_DEVICE_GAP, Pipeline)
    from fluorosequencingimageanalysis_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    stack = _experiment_stack()[:3]
    multi = Pipeline(_config(), device=["cpu", "cpu"])
    one = Pipeline(_config(), device="cpu")
    assert multi.mesh.shape == {"data": 2, "model": 1}
    assert multi.device == torch.device("cpu")
    got, want = multi.run_stack(stack), one.run_stack(stack)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape[0] == 3, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a = multi.run_experiment(stack, csv_path=str(tmp_path / "multi.csv"))
    b = one.run_experiment(stack, csv_path=str(tmp_path / "one.csv"))
    assert a["rows"] and len(a["rows"]) == len(b["rows"])
    assert open(tmp_path / "multi.csv", "rb").read() == \
        open(tmp_path / "one.csv", "rb").read()
    mesh_pipe = Pipeline(_config(), device=make_mesh(devices=["cpu"] * 2))
    for call in (lambda p: p.run_zstack(_frames()),
                 lambda p: p.run_timetrace(_movie()),
                 lambda p: p.run_timetraces([_movie()]),
                 lambda p: p.stepfit(np.zeros((2, 20))),
                 lambda p: p.fluor_counts({}, 30000.0, 0.2),
                 lambda p: p.fluor_counts_calibrated({}),
                 lambda p: p.per_cycle_gmm({}),
                 lambda p: p.simulate_signals(["AK"], 0.9, 0.05, 0.1,
                                              [(0, 1)])):
        for pipe in (multi, mesh_pipe):
            with pytest.raises(NotImplementedError,
                               match="ROADMAP Queue 1, item 3"):
                call(pipe)
    assert "ROADMAP" in MULTI_DEVICE_GAP


# -- multihost: initialize ---------------------------------------------------

@pytest.fixture
def fresh_multihost(monkeypatch):
    from fluorosequencingimageanalysis_torch.parallel import multihost
    monkeypatch.setattr(multihost, "_INITIALIZED", False)
    monkeypatch.setattr(multihost, "_LOCAL_DEVICES", None)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    return multihost


def test_initialize_single_process_is_noop(fresh_multihost):
    """No argument and no group in the environment: a no-op, twice."""
    mh = fresh_multihost
    mh.initialize()
    mh.initialize()
    assert not torch.distributed.is_initialized()
    assert mh.process_count() == 1 and mh.process_index() == 0
    assert mh._allgather_pickled({"a": 1}) == [{"a": 1}]
    np.testing.assert_array_equal(mh.allgather(np.arange(3)), np.arange(3))


def test_initialize_explicit_bad_coordinator_still_raises(fresh_multihost):
    """num_processes and process_id without a coordinator is a broken
    launch, not one process."""
    with pytest.raises(ValueError, match="together"):
        fresh_multihost.initialize(num_processes=2, process_id=0)
    assert not torch.distributed.is_initialized()


def test_initialize_partial_spec_still_raises(fresh_multihost):
    with pytest.raises(ValueError, match="together"):
        fresh_multihost.initialize(process_id=0)
    with pytest.raises(ValueError, match="together"):
        fresh_multihost.initialize(local_device_ids=[0])
    assert not torch.distributed.is_initialized()


# -- multihost: two processes over gloo --------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(mode, out_dir, nproc=2):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + HERE,
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r),
         str(nproc), str(port), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nproc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def test_two_processes_run_the_step_and_the_experiment(tmp_path):
    """Fields 0-1 in process 0, 2-3 in process 1: run_experiment_step's
    gathered outputs equal the one-device step on all four fields, and
    both processes' run_experiment CSVs are byte-identical to one
    process's Pipeline.run_experiment."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        experiment_step)
    _run_children("experiment", tmp_path)
    stack = _experiment_stack()
    torch.set_num_threads(1)
    with torch.no_grad():
        want = {k: v.numpy() for k, v in experiment_step(
            torch.from_numpy(stack), **STEP).items()}
    for r in range(2):
        got = dict(np.load(tmp_path / f"step_{r}.npz"))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    Pipeline(_config(), device="cpu").run_experiment(
        stack, csv_path=str(tmp_path / "single.csv"))
    single = open(tmp_path / "single.csv", "rb").read()
    assert single.count(b"\n") > 20
    for r in range(2):
        assert open(tmp_path / f"exp_{r}.csv", "rb").read() == single


def test_two_processes_run_the_timetrace_tracker_and_background(tmp_path):
    """Both processes' run_timetrace CSVs are byte-identical to one
    process's Pipeline.run_timetrace; lc_track equals the one-process
    tracker; stack_background over 3 + 3 frames equals the background of
    all 6."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.ops.background import (
        stack_background)
    from fluorosequencingimageanalysis_torch.pipeline.fast_timetrace import (
        lc_track)
    _run_children("timetrace", tmp_path)
    torch.set_num_threads(1)
    res = Pipeline(_config(), device="cpu").run_timetrace(
        _movie(), csv_path=str(tmp_path / "single.csv"), **TT_KW)
    single = open(tmp_path / "single.csv", "rb").read()
    assert res["trace_count"] >= 3
    h0, w0 = res["traces"]["h"], res["traces"]["w"]
    want_track = lc_track(_movie(), h0, w0, device="cpu")
    want_bg = stack_background(_frames(), device="cpu").numpy()
    for r in range(2):
        assert open(tmp_path / f"tt_{r}.csv", "rb").read() == single
        got = np.load(tmp_path / f"track_{r}.npz")
        for i, k in enumerate(("rec_h", "rec_w", "present")):
            np.testing.assert_array_equal(got[k], want_track[i], err_msg=k)
        np.testing.assert_array_equal(got["background"], want_bg)


# -- the child process -------------------------------------------------------

def _child(mode, rank, nproc, port, out_dir):
    from fluorosequencingimageanalysis_torch.parallel import multihost
    from fluorosequencingimageanalysis_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=nproc,
                         process_id=rank)
    assert multihost.process_count() == nproc
    assert multihost.process_index() == rank
    mesh = make_mesh(devices=["cpu"])
    if mode == "experiment":
        stack = _experiment_stack()
        share = stack.shape[0] // nproc
        local = stack[rank * share:(rank + 1) * share]
        step = multihost.run_experiment_step(local, mesh=mesh, **STEP)
        np.savez(os.path.join(out_dir, f"step_{rank}.npz"), **step)
        multihost.run_experiment(local, csv_path=os.path.join(
            out_dir, f"exp_{rank}.csv"), config=_config(), mesh=mesh)
    else:
        movie = _movie()
        res = multihost.run_timetrace(movie, csv_path=os.path.join(
            out_dir, f"tt_{rank}.csv"), config=_config(), mesh=mesh,
            **TT_KW)
        rec = multihost.lc_track(movie, res["traces"]["h"],
                                 res["traces"]["w"], mesh=mesh)
        frames = _frames()
        share = frames.shape[0] // nproc
        bg = multihost.stack_background(
            frames[rank * share:(rank + 1) * share], mesh=mesh)
        np.savez(os.path.join(out_dir, f"track_{rank}.npz"),
                 rec_h=rec[0], rec_w=rec[1], present=rec[2], background=bg)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5])
