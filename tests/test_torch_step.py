"""Port parity: the whole experiment step and Pipeline.run_stack vs JAX.

The port's experiment_step is held against experiment_step_sharded on a
one-device mesh, called as tests/test_multihost.py calls it. Integer and
bool outputs (candidate counts, keep masks, the whole spot bucket) must be
equal; kept-fit centers within 1e-3 px (float32 LM, converged); photometry
within rtol 1e-4 (float32 sums in another order); offsets (quantised to
1/upsample_factor px) equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multihost_worker import synthetic_stack

from fluorosequencingimageanalysis_tpu.config import (
    DetectConfig as JaxDetectConfig, PipelineConfig as JaxPipelineConfig)
from fluorosequencingimageanalysis_tpu.parallel.mesh import (
    experiment_step_sharded, make_mesh)

from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (
    DetectConfig, PhotometryConfig, PipelineConfig, RegistrationConfig)
from fluorosequencingimageanalysis_torch.parallel.mesh import experiment_step
from fluorosequencingimageanalysis_torch.utils import convert, synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

STEP = dict(max_candidates=64, num_iters=20, upsample_factor=5)
FLOAT_KEYS = ("offsets_h", "offsets_w", "params", "center_h", "center_w",
              "spot_h", "spot_w", "photometry")


def _stack():
    # F=2 fields x C=3 cycles of 64x64; cycle 2 of field 1 is shifted by a
    # whole pixel so registration has something to find.
    stack = synthetic_stack(F=2, C=3)
    stack[1, 2] = np.roll(stack[1, 2], (1, -2), axis=(0, 1))
    return stack


def _jax_step(stack, **kw):
    out = experiment_step_sharded(jnp.asarray(stack), make_mesh(1),
                                  **STEP, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_step_parity(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k], ref[k]
        assert g.shape == r.shape, k
        # cand_count is int64 on the JAX side only because the tests run
        # JAX with x64 enabled; the device schema is int32.
        assert g.dtype == (np.int32 if k == "cand_count" else r.dtype), k
        if k not in FLOAT_KEYS:
            np.testing.assert_array_equal(g, r, err_msg=k)
    np.testing.assert_array_equal(got["offsets_h"], ref["offsets_h"])
    np.testing.assert_array_equal(got["offsets_w"], ref["offsets_w"])
    keep = ref["keep"]
    for k in ("center_h", "center_w"):
        np.testing.assert_allclose(got[k][keep], ref[k][keep], atol=1e-3,
                                   err_msg=k)
    v = ref["spot_valid"]
    for k in ("spot_h", "spot_w"):
        np.testing.assert_allclose(got[k][v], ref[k][v], atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(got["photometry"], ref["photometry"],
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("phot", [
    dict(),
    dict(photometry_method="maximum", photometry_min=3000.0),
    dict(photometry_method="gaussian_volume", max_spots=3),
])
def test_experiment_step_matches_jax(phot):
    stack = _stack()
    ref = _jax_step(stack, **phot)
    got = {k: v.numpy() for k, v in experiment_step(
        torch.from_numpy(stack), **STEP, **phot).items()}
    _assert_step_parity(got, ref)
    assert ref["keep"].sum() > 0 and ref["spot_valid"].sum() > 0
    assert not np.all(ref["offsets_h"] == 0)
    if "max_spots" in phot:
        assert ref["spot_overflow"].any()  # 4 spots per image, 3 slots


def test_pipeline_cpu_run_stack_matches_the_step_and_normalises_dtypes():
    stack = _stack()
    cfg = PipelineConfig(detect=DetectConfig(max_candidates=64,
                                             num_iters=20),
                         registration=RegistrationConfig(upsample_factor=5))
    pipe = Pipeline(cfg, device="cpu")
    out = pipe.run_stack(stack)
    ref = {k: v.numpy() for k, v in experiment_step(
        torch.from_numpy(stack), **STEP).items()}
    assert set(out) == set(ref)
    for k in ref:
        assert isinstance(out[k], np.ndarray)
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    # uint16 frames upload as-is and are cast on the device: same result
    # as the float32 cast of the same frames; float64 is cast on the host.
    as_u16 = np.clip(np.round(stack), 0, 65535).astype(np.uint16)
    got16 = pipe.run_stack(as_u16, keys=["keep", "spot_h", "photometry"])
    got32 = pipe.run_stack(as_u16.astype(np.float32),
                           keys=("keep", "spot_h", "photometry"))
    assert set(got16) == {"keep", "spot_h", "photometry"}
    for k in got16:
        np.testing.assert_array_equal(got16[k], got32[k])
    got64 = pipe.run_stack(stack.astype(np.float64), keys=["photometry"])
    np.testing.assert_array_equal(got64["photometry"], ref["photometry"])
    # Overrides: max_candidates, max_spots, photometry method and floor.
    o = pipe.run_stack(stack, max_candidates=32, max_spots=2,
                       photometry_method="simple", photometry_min=1e9)
    assert o["keep"].shape == (2, 3, 32) and o["spot_h"].shape == (2, 3, 2)
    assert np.all(o["photometry"][o["spot_valid"]] == 1e9)


def test_step_rejects_bad_arguments():
    x = torch.zeros((1, 2, 32, 32))
    with pytest.raises(ValueError, match="max_spots"):
        experiment_step(x, max_candidates=8, max_spots=16)
    with pytest.raises(ValueError, match="photometry_method"):
        experiment_step(x, max_candidates=8, photometry_method="sextractor")
    with pytest.raises(ValueError, match="non-empty"):
        Pipeline(device="cpu").run_stack(np.zeros((0, 2, 8, 8)))
    with pytest.raises(ValueError, match="non-empty"):
        Pipeline(device="cpu").run_stack(np.zeros((2, 8, 8)))


def test_step_kwargs_read_either_packages_config():
    jcfg = JaxPipelineConfig(detect=JaxDetectConfig(c_std=3.0, num_iters=7,
                                                    use_pallas=True))
    tcfg = PipelineConfig(detect=DetectConfig(c_std=3.0, num_iters=7),
                          photometry=PhotometryConfig())
    assert convert.step_kwargs(jcfg) == convert.step_kwargs(tcfg)
    kw = convert.step_kwargs(tcfg, np.ones((5, 5)))
    assert kw["c_std"] == 3.0 and kw["num_iters"] == 7
    assert kw["correlation_matrix"].dtype == np.float64
    for name in convert.IGNORED_DETECT_FIELDS:
        assert name not in kw


def test_synthetic_stack_is_the_benchmark_recipe_and_recall_counts():
    import bench
    stack, spots = synth.make_stack(2, 2, 96, 96, spots_per_field=12,
                                    seed=5)
    np.testing.assert_array_equal(
        stack, bench.make_stack(2, 2, 96, 96, spots_per_field=12, seed=5))
    assert spots.shape == (2, 12, 2)
    cfg = PipelineConfig(detect=DetectConfig(max_candidates=128,
                                             num_iters=20))
    out = Pipeline(cfg, device="cpu").run_stack(stack)
    assert synth.recall(spots, out) >= 0.9
    # Fitted PSF peaks of kept spots land near planted centers.
    rows, cols = synth.model_peaks(out)
    v = out["spot_valid"]
    assert np.isfinite(rows[v]).all() and np.isfinite(cols[v]).all()
    empty = {k: np.zeros_like(a) for k, a in out.items()}
    assert synth.recall(spots, empty) == 0.0
