"""Port parity: ``Pipeline.run_zstack`` and the artifact store vs JAX.

Six uint16 frames of 96x96 (a sloped background plus planted spots) go
through the JAX package's ``Pipeline(mesh=make_mesh(1)).run_zstack`` and
the port's ``Pipeline(device="cpu").run_zstack``. Tolerances: candidate
coordinates, validity and keep masks, counts and lean buckets' integer and
bool parts equal; kept centers within 1e-3 px; the other kept floats
(params without theta, rmse, r2, s_n) within rtol 5e-3, atol 5e-3;
background maps within 5e-5 of their scale. The JAX side runs with x64 on
(tests/conftest.py), so its counts are int64; the port's schema is the
device one (int32, float32). Store keys (``content_key``) are equal.
"""

import logging

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_tpu.api import Pipeline as JaxPipeline
from fluorosequencingimageanalysis_tpu.config import (
    DetectConfig as JaxDetectConfig, PipelineConfig as JaxPipelineConfig)
from fluorosequencingimageanalysis_tpu.parallel.mesh import make_mesh
from fluorosequencingimageanalysis_tpu.utils import checkpoint as jax_ckpt

from fluorosequencingimageanalysis_torch import api
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (DetectConfig,
                                                        PipelineConfig)
from fluorosequencingimageanalysis_torch.utils import checkpoint, profiling
from fluorosequencingimageanalysis_torch.utils import synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

DET = dict(max_candidates=256, num_iters=20)
BOX = dict(box_size=16, filter_size=3)
CENTER_ATOL = 1e-3
FLOAT_TOL = dict(rtol=5e-3, atol=5e-3)
INT_KEYS = ("cand_h", "cand_w", "keep", "cand_valid", "cand_count")


@pytest.fixture(scope="module")
def stack():
    rng = np.random.default_rng(23)
    T, H, W = 6, 96, 96
    yy, xx = np.mgrid[:H, :W]
    frames = np.empty((T, H, W))
    pos = rng.uniform(8, H - 8, (12, 2))
    amp = rng.uniform(900, 1800, 12)
    for t in range(T):
        img = 800 + 2.0 * yy + 1.2 * xx + 15 * t + rng.normal(0, 4, (H, W))
        for (h, w), a in zip(pos, amp):
            img += a * np.exp(-((yy - h) ** 2 + (xx - w) ** 2) / 2.6)
        frames[t] = img
    return np.round(frames).astype(np.uint16)


def _jax_pipe(**kw):
    return JaxPipeline(JaxPipelineConfig(detect=JaxDetectConfig(**DET)),
                       mesh=make_mesh(1), **kw)


def _port_pipe(**kw):
    return Pipeline(PipelineConfig(detect=DetectConfig(**DET)),
                    device="cpu", **kw)


def _assert_zstack_parity(got, ref, lean=False):
    assert set(got) == set(ref)
    ints = INT_KEYS + (("spot_count",) if lean else ())
    for k in ints:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["cand_count"].dtype == np.int32
    assert got["cand_h"].dtype == np.int32 and got["keep"].dtype == bool
    keep = ref["keep"]
    assert keep.sum() >= 6 * 8
    for k in ("center_h", "center_w"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k][keep], ref[k][keep],
                                   atol=CENTER_ATOL, err_msg=k)
    for k in ("rmse", "r2", "s_n"):
        np.testing.assert_allclose(got[k][keep], ref[k][keep], err_msg=k,
                                   **FLOAT_TOL)
    np.testing.assert_allclose(got["params"][keep][:, :6],
                               ref["params"][keep][:, :6], **FLOAT_TOL)


@pytest.fixture(scope="module")
def capped(stack):
    return _port_pipe().run_zstack(stack, return_background=True, **BOX)


def test_run_zstack_capped_matches_jax(stack, capped):
    ref = _jax_pipe().run_zstack(stack, return_background=True, **BOX)
    _assert_zstack_parity(capped, ref)
    assert capped["keep"].shape == (6, 256)
    bg, rbg = capped["background"], ref["background"]
    assert bg.dtype == np.float32 and bg.shape == stack.shape
    assert np.abs(bg - rbg).max() / np.abs(rbg).max() < 5e-5
    # Every frame keeps the planted spots at the same places.
    assert (capped["keep"].sum(axis=1) >= 8).all()


def test_run_zstack_exhaustive_matches_jax(stack, capped):
    ref = _jax_pipe().run_zstack(stack, max_candidates="exhaustive", **BOX)
    got = _port_pipe().run_zstack(stack, max_candidates="exhaustive", **BOX)
    # K = chunks * chunk: the JAX package probes its chunk per backend,
    # the port's is fixed (EXHAUSTIVE_CHUNK); beyond the narrower of the
    # two, every slot is padding.
    K = min(got["keep"].shape[1], ref["keep"].shape[1])
    assert got["keep"].shape == (6, 4096) and K >= 256
    for out in (got, ref):
        assert not out["cand_valid"][:, K:].any()
        for k in out:
            if k != "cand_count":
                out[k] = out[k][:, :K]
    _assert_zstack_parity(got, ref)
    # No frame overflows the 256 bucket here, so the exhaustive keep sets
    # are the capped run's.
    assert (capped["cand_count"] <= 256).all()
    np.testing.assert_array_equal(got["cand_count"], capped["cand_count"])
    np.testing.assert_array_equal(got["keep"][:, :256], capped["keep"])
    assert not got["keep"][:, 256:].any()
    for k in ("center_h", "params", "r2", "cand_h"):
        np.testing.assert_array_equal(got[k][:, :256][capped["cand_valid"]],
                                      capped[k][capped["cand_valid"]])


def test_run_zstack_exhaustive_pads_groups_to_the_widest(stack, monkeypatch):
    from fluorosequencingimageanalysis_torch.models import detect
    monkeypatch.setattr(api, "GROUP_FRAMES", 4)
    monkeypatch.setattr(detect, "EXHAUSTIVE_CHUNK", 64)
    busy = stack.copy()
    busy[:4, 20:70:6, 20:70:6] += 300   # hot pixels: more candidates
    pipe = _port_pipe()
    got = pipe.run_zstack(busy, max_candidates="exhaustive",
                          return_background=True, psfs=True, **BOX)
    widths = [-(-int(got["cand_count"][lo:lo + 4].max()) // 64) * 64
              for lo in (0, 4)]
    assert widths[0] != widths[1]
    K = max(widths)
    assert got["keep"].shape == (6, K) and got["params"].shape == (6, K, 7)
    narrow = slice(0, 4) if widths[0] < K else slice(4, 6)
    pad = slice(min(widths), K)
    assert (got["cand_h"][narrow, pad] == 2).all()
    assert (got["cand_w"][narrow, pad] == 2).all()
    assert not got["keep"][narrow, pad].any()
    assert not got["cand_valid"][narrow, pad].any()
    assert (got["r2"][narrow, pad] == 0).all()
    assert got["background"].shape == busy.shape and len(got["psfs"]) == 6
    one = pipe.run_zstack(busy[4:], max_candidates="exhaustive", **BOX)
    n = one["keep"].shape[1]
    np.testing.assert_array_equal(got["keep"][4:, :n], one["keep"])
    np.testing.assert_array_equal(got["center_h"][4:, :n], one["center_h"])


def test_run_zstack_lean_matches_jax_and_the_full_schema(stack, capped):
    kw = dict(lean=True, max_spots=24, **BOX)
    ref = _jax_pipe().run_zstack(stack, **kw)
    got = _port_pipe().run_zstack(stack, **kw)
    assert list(got) == list(ref)
    _assert_zstack_parity(got, ref, lean=True)
    assert got["keep"].shape == (6, 24) and got["spot_count"].dtype == np.int32
    # Kept slots: the full schema's values in candidate order, bit for bit.
    for t in range(6):
        first = np.nonzero(capped["keep"][t])[0][:24]
        n = len(first)
        assert got["spot_count"][t] == capped["keep"][t].sum() == n
        assert got["keep"][t, :n].all() and not got["keep"][t, n:].any()
        for k in ("cand_h", "cand_w", "center_h", "center_w", "rmse", "r2",
                  "s_n", "params"):
            np.testing.assert_array_equal(got[k][t, :n], capped[k][t][first],
                                          err_msg=k)
    # The default bucket is 2048 slots, cut to the candidate bucket.
    assert _port_pipe().run_zstack(stack[:1], lean=True, **BOX)[
        "keep"].shape == (1, 256)
    with pytest.warns(UserWarning, match="exceed max_spots=4"):
        cut = _port_pipe().run_zstack(stack[:2], lean=True, max_spots=4,
                                      **BOX)
    assert cut["keep"].shape == (2, 4) and (cut["spot_count"] > 4).all()


def test_run_zstack_psfs_match_jax(stack, capped):
    ref = _jax_pipe().run_zstack(stack[:3], psfs=True, **BOX)
    got = _port_pipe().run_zstack(stack[:3], psfs=True, **BOX)
    assert set(got) == set(ref) and "subtracted" not in got
    assert len(got["psfs"]) == 3
    for t, (g, r) in enumerate(zip(got["psfs"], ref["psfs"])):
        assert list(g) == list(r) and len(g) == capped["keep"][t].sum()
        for key in r:
            np.testing.assert_allclose(g[key][:2], r[key][:2],
                                       atol=CENTER_ATOL)
            np.testing.assert_allclose(g[key][2:6], r[key][2:6], **FLOAT_TOL)
            # sub_img is the int64 cast of the subtracted frame's patch: a
            # float32 background that differs in its last digits moves a
            # value across an integer now and then.
            assert g[key][7].dtype == np.int64
            assert np.abs(g[key][7] - r[key][7]).max() <= 1


def test_run_zstack_groups_dtypes_and_device_tensors(stack, capped,
                                                     monkeypatch):
    pipe = _port_pipe()
    profiling.reset_counters()
    monkeypatch.setattr(api, "GROUP_FRAMES", 4)   # 6 frames: groups of 4, 2
    grouped = pipe.run_zstack(stack, return_background=True, **BOX)
    counts = profiling.counters()
    assert counts["ledger/uploads"] == 2
    assert counts["ledger/upload_bytes"] == stack.nbytes
    assert counts["ledger/step_dispatches"] == 2
    assert counts["ledger/result_fetches"] == 2 * 12
    assert counts["ledger/fetch_bytes"] == sum(v.nbytes
                                               for v in grouped.values())
    assert list(grouped) == list(capped)
    for k in capped:
        np.testing.assert_array_equal(grouped[k], capped[k], err_msg=k)
    # uint16 frames widen on the device: the float32 cast's result; float64
    # is cast on the host.
    for other in (stack.astype(np.float32), stack.astype(np.float64)):
        out = pipe.run_zstack(other, **BOX)
        for k in out:
            np.testing.assert_array_equal(out[k], capped[k], err_msg=k)
    # A tensor already on the device runs as one group, with no upload.
    profiling.reset_counters()
    whole = pipe.run_zstack(torch.from_numpy(stack), **BOX)
    assert "ledger/uploads" not in profiling.counters()
    assert profiling.counters()["ledger/step_dispatches"] == 1
    for k in whole:
        np.testing.assert_array_equal(whole[k], capped[k], err_msg=k)
    profiling.reset_counters()


def test_run_zstack_rejects_and_warns(stack, caplog):
    pipe = _port_pipe()
    with pytest.raises(ValueError, match="non-empty"):
        pipe.run_zstack(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="non-empty"):
        pipe.run_zstack(np.zeros((0, 4, 4), np.float32))
    with pytest.raises(ValueError, match="lean=True requires"):
        pipe.run_zstack(stack, lean=True, max_candidates="exhaustive")
    with pytest.raises(ValueError, match="lean=True requires"):
        pipe.run_zstack(stack, lean=True, psfs=True)
    tight = Pipeline(PipelineConfig(detect=DetectConfig(
        consolidation_radius=1.5)), device="cpu")
    with pytest.raises(ValueError, match="consolidation_radius"):
        tight.run_zstack(np.zeros((2, 32, 32), np.float32), psfs=True)
    with caplog.at_level(logging.WARNING):
        out = pipe.run_zstack(stack[:2], max_candidates=16, **BOX)
    assert out["keep"].shape == (2, 16)
    assert any("run_zstack: 2 image(s) exceed max_candidates=16" in r.message
               for r in caplog.records)
    profiling.reset_timings()
    Pipeline(PipelineConfig(detect=DetectConfig(**DET)), device="cpu",
             profile=True).run_zstack(stack[:1], **BOX)
    assert profiling.timings()["api/run_zstack"]["count"] == 1
    profiling.reset_timings()


def test_content_keys_equal_the_jax_packages(stack):
    cfg = PipelineConfig().asdict()
    parts = ("run_zstack", stack, cfg, 16, 3, "exhaustive", True,
             ("lean", 2048), None, 2.5, b"raw", [1, (2, "x")],
             {"b": np.arange(3), "a": 1})
    assert checkpoint.content_key(*parts) == jax_ckpt.content_key(*parts)
    assert checkpoint.content_key("as", "b") != checkpoint.content_key(
        "a", "sb")
    assert checkpoint.content_key(torch.from_numpy(stack)) == \
        jax_ckpt.content_key(stack)
    assert cfg == JaxPipelineConfig().asdict()


def test_store_serves_the_second_call(stack, capped, tmp_path, monkeypatch):
    store = checkpoint.ArtifactStore(str(tmp_path / "store"))
    pipe = _port_pipe(store=store)
    first = pipe.run_zstack(stack, **BOX)
    keys = list(store.keys())
    assert len(keys) == 1 and store.meta(keys[0]) == {"stage": "run_zstack"}
    # The key is the JAX package's for the same call.
    assert keys[0] == jax_ckpt.content_key(
        "run_zstack", jax_ckpt.content_key(stack), pipe.config.asdict(), 16,
        3, 256, False)
    calls = []
    from fluorosequencingimageanalysis_torch.ops import background
    real = background.stack_background
    monkeypatch.setattr(background, "stack_background",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    second = pipe.run_zstack(stack, **BOX)
    assert calls == []                      # served from the store
    assert set(second) == set(first)
    for k in first:
        np.testing.assert_array_equal(first[k], np.asarray(second[k]))
        np.testing.assert_array_equal(first[k], capped[k])
    # Other arguments are other entries; psfs runs always compute.
    pipe.run_zstack(stack, lean=True, max_spots=24, **BOX)
    pipe.run_zstack(stack, stack_key="given", **BOX)
    assert len(list(store.keys())) == 3 and calls == [1, 1]
    pipe.run_zstack(stack[:1], psfs=True, **BOX)
    assert len(list(store.keys())) == 3 and calls == [1, 1, 1]


def test_store_serves_run_stack_and_run_experiment(tmp_path, monkeypatch):
    from fluorosequencingimageanalysis_torch.parallel import mesh
    exp = synth.make_experiment_stack(3, 3, 64, 64, spots_per_field=6)
    cfg = PipelineConfig(detect=DetectConfig(max_candidates=64,
                                             num_iters=10))
    store = checkpoint.ArtifactStore(str(tmp_path / "store"))
    pipe = Pipeline(cfg, device="cpu", store=store)
    plain = Pipeline(cfg, device="cpu")
    monkeypatch.setattr(api, "GROUP_FIELDS", 2)
    steps = []
    real = mesh.experiment_step
    monkeypatch.setattr(mesh, "experiment_step",
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    a = pipe.run_stack(exp, keys=("keep", "photometry"))
    assert steps == [1]
    b = pipe.run_stack(exp, keys=["photometry", "keep"])
    assert steps == [1] and set(b) == {"keep", "photometry"}
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert list(store.keys()) == [jax_ckpt.content_key(
        "run_stack", jax_ckpt.content_key(exp), cfg.asdict(), 64, None,
        ["keep", "photometry"], "mexican_hat", None)]
    first = pipe.run_experiment(exp)
    assert len(steps) == 3                  # two groups of fields
    second = pipe.run_experiment(exp)
    assert len(steps) == 3                  # the step came from the store
    want = plain.run_experiment(exp)
    assert len(want["rows"]) > 0
    for got in (first, second):
        assert len(got["rows"]) == len(want["rows"])
        for g, w in zip(got["rows"], want["rows"]):
            assert g[:5] == w[:5]
            np.testing.assert_array_equal(g[5], w[5])
        assert got["summary"] == want["summary"]
    assert len(list(store.keys())) == 2
