"""Port parity: the exhaustive detect path and the find_peptides family.

Inputs come from a numpy seed and go through the JAX function (plain
path, ``use_pallas=False``, ``gather_strategy="gather"``) and its
counterpart in the port on the CPU. Tolerances:

- candidate coordinates, validity and keep masks, counts, the exclusion
  mask, psfs keys and their order, ``sub_img`` and the lean buckets' integer
  and bool parts: equal;
- fitted centers of kept fits: 1e-3 px (float32 LM, converged);
- the other floats of a psfs tuple (H, A, sigmas, rmse, r_2, s_n): rtol
  5e-3, atol 5e-3 (the step's tolerance for fit products of another
  summation order). theta is not compared: on a near-circular spot the
  cost is flat in it, and two float32 LM runs end degrees apart with the
  same model image (which ``fit_img`` holds);
- ``fit_img``: the port returns float32 (the JAX package's production
  dtype; under this suite's x64 it returns float64). On the same kept
  parameters it is held at rtol 1e-5; between the packages' own fits (whose
  centers differ by up to 1e-3 px) at 2e-3 of the patch's peak;
- ``pack_spot_buckets`` on one shared result: every array equal.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluorosequencingimageanalysis_tpu.models import detect as jax_detect
from fluorosequencingimageanalysis_tpu.ops import candidates as jax_cand
from fluorosequencingimageanalysis_tpu.ops import consolidate as jax_cons

from fluorosequencingimageanalysis_torch.models import detect as port_detect
from fluorosequencingimageanalysis_torch.ops import candidates as port_cand
from fluorosequencingimageanalysis_torch.ops import consolidate as port_cons
from fluorosequencingimageanalysis_torch.utils import convert

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

CENTER_ATOL = 1e-3
FLOAT_TOL = dict(rtol=5e-3, atol=5e-3)
FIT_IMG_REL = 2e-3
JAX_KW = dict(use_pallas=False, gather_strategy="gather")
INT_FIELDS = ("cand_h", "cand_w", "keep", "cand_valid", "cand_count")


def _field(seed, H=96, W=96, n_spots=14, noise=6.0):
    """Planted Gaussian spots (sigma 1.2, subpixel centers) on N(400,
    noise); a close pair makes the consolidation do something."""
    rng = np.random.default_rng(seed)
    yy, xx = np.indices((H, W)).astype(np.float64)
    img = rng.normal(400.0, noise, (H, W))
    pos = rng.uniform(8, min(H, W) - 8, (n_spots, 2))
    pos[1] = pos[0] + [2.5, 1.5]
    for (h, w), a in zip(pos, rng.uniform(1500, 4000, n_spots)):
        img += a * np.exp(-((yy - h) ** 2 + (xx - w) ** 2) / (2 * 1.2 ** 2))
    return img.astype(np.float32)


def _assert_result_parity(got, ref):
    """A port SpotFindResult (numpy) against the JAX one."""
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    keep = np.asarray(ref.keep)
    assert keep.sum() > 0
    for name in ("center_h", "center_w"):
        np.testing.assert_allclose(getattr(got, name)[keep],
                                   np.asarray(getattr(ref, name))[keep],
                                   atol=CENTER_ATOL, err_msg=name)
    for name in ("rmse", "r2", "s_n", "params"):
        g = getattr(got, name)[keep]
        r = np.asarray(getattr(ref, name))[keep]
        if name == "params":
            g, r = g[:, :6], r[:, :6]
        np.testing.assert_allclose(g, r, err_msg=name, **FLOAT_TOL)


def _assert_psfs_parity(got, ref, image):
    assert list(got) == list(ref)          # equal key sets, equal order
    assert len(ref) > 0
    for key, r in ref.items():
        g = got[key]
        np.testing.assert_allclose(g[:2], r[:2], atol=CENTER_ATOL)
        np.testing.assert_allclose(g[2:6], r[2:6], **FLOAT_TOL)
        np.testing.assert_allclose(g[9:], r[9:], **FLOAT_TOL)
        assert g[7].dtype == np.int64 and g[7].shape == (5, 5)
        np.testing.assert_array_equal(g[7], r[7])
        assert g[8].dtype == np.float32 and g[8].shape == (5, 5)
        np.testing.assert_allclose(g[8], r[8], rtol=0,
                                   atol=FIT_IMG_REL * np.abs(r[8]).max())


def test_extract_candidates_chunk_equals_jax_and_one_big_extraction():
    rng = np.random.default_rng(3)
    B, H, W, chunk = 2, 24, 28, 16
    # Few distinct scores: most neighbours in the ranking tie, so ties
    # straddle both chunk boundaries.
    cms = rng.integers(0, 4, (B, H, W)).astype(np.float32) * 100.0
    cms[:, 5:9, 5:20] = 900.0
    cms[1, 12:14, 3:25] = 700.0
    c_std = 0.5
    jx_ex = jnp.zeros((B, H * W), bool)
    pt_ex = torch.zeros((B, H * W), dtype=torch.bool)
    got_parts = []
    for i in range(3):
        jx = jax_cand.extract_candidates_chunk(jnp.asarray(cms), jx_ex,
                                               chunk, c_std)
        pt = port_cand.extract_candidates_chunk(torch.from_numpy(cms),
                                                pt_ex, chunk, c_std)
        for a, b, name in zip(pt, jx, ("hs", "ws", "valid", "remaining",
                                       "excluded")):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name}, chunk {i}")
        assert pt[0].dtype == torch.int32 and pt[3].dtype == torch.int32
        jx_ex, pt_ex = jx[4], pt[4]
        got_parts.append(pt)
    total = got_parts[0][3].numpy()
    assert (total > 3 * chunk).all()        # every chunk was full
    assert pt_ex.sum(dim=1).tolist() == [3 * chunk] * B
    big = port_cand._threshold_and_extract_batch(torch.from_numpy(cms),
                                                 3 * chunk, c_std)
    for j, name in enumerate(("hs", "ws", "valid")):
        np.testing.assert_array_equal(
            torch.cat([p[j] for p in got_parts], dim=1).numpy(),
            big[j].numpy(), err_msg=name)
    np.testing.assert_array_equal(total, big[3].numpy())
    # The maps without extraction are find_candidates_batch's front half.
    x = torch.from_numpy(_field(0, 40, 40, 4))[None]
    np.testing.assert_array_equal(
        port_cand.candidate_maps_batch(x).numpy(),
        port_cand.correlation_maps(
            x, 5, torch.from_numpy(port_cand.DEFAULT_CORRELATION_MATRIX
                                   ).float()).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consolidate_host_equals_jax_and_the_device_fixpoint(seed):
    rng = np.random.default_rng(seed)
    n = 300
    ch = rng.uniform(0, 60, n).astype(np.float32)
    cw = rng.uniform(0, 60, n).astype(np.float32)
    r2 = rng.uniform(0.5, 1.0, n).astype(np.float32)
    r2[rng.integers(0, n, 20)] = np.nan         # NaN scores rank last
    r2[10:14] = r2[10]                          # ties: lower index wins
    ch[5], cw[7] = np.nan, np.inf               # kept, never rivals
    valid = rng.random(n) < 0.9
    valid[[5, 7]] = True
    for radius in (4.0, 2.0):
        want = jax_cons.consolidate_host(ch, cw, r2, valid, radius=radius)
        got = port_cons.consolidate_host(ch, cw, r2, valid, radius=radius)
        np.testing.assert_array_equal(got, want)
        dev = port_cons.consolidate(*(torch.from_numpy(a) for a in
                                      (ch, cw, r2, valid)), radius=radius)
        np.testing.assert_array_equal(got, dev.numpy())
        assert got[5] and got[7] and not got[~valid].any()
        assert 0 < got.sum() < valid.sum()


def test_consolidate_host_float64_boundary():
    # h = 0.1 and 4.1 differ by exactly 4.0 in float64 but not after a
    # float32 round; 4.0000001 is beyond the radius only in float64.
    ch = np.array([0.1, 4.1, 20.0, 20.0 + 4.0000001], np.float64)
    cw = np.ones(4, np.float64)
    r2 = np.array([0.9, 0.8, 0.9, 0.95], np.float64)
    valid = np.ones(4, bool)
    got = port_cons.consolidate_host(ch, cw, r2, valid, radius=4.0)
    np.testing.assert_array_equal(
        got, jax_cons.consolidate_host(ch, cw, r2, valid, radius=4.0))
    assert got.tolist() == [True, False, True, True]
    dev = port_cons.consolidate(*(torch.from_numpy(a) for a in
                                  (ch, cw, r2, valid)), radius=4.0)
    assert dev.tolist() == got.tolist()


def test_detect_and_fit_exhaustive_matches_jax(caplog):
    imgs = np.stack([_field(0), _field(1, n_spots=9, noise=9.0)])
    ref = jax_detect.detect_and_fit_exhaustive(
        jnp.asarray(imgs), chunk=128, num_iters=20, **JAX_KW)
    got = port_detect.detect_and_fit_exhaustive(imgs, chunk=128,
                                                num_iters=20, device="cpu")
    assert all(isinstance(a, np.ndarray) for a in got)
    assert got.cand_count.dtype == np.int32
    assert got.keep.shape == np.asarray(ref.keep).shape
    assert got.keep.shape[1] > 128 and got.keep.shape[1] % 128 == 0
    _assert_result_parity(got, ref)
    # Chunked equals single-bucket, whatever the chunk: same kept
    # candidates with the same fits, bit for bit within the port.
    k = got.keep.shape[1]
    with torch.no_grad():
        single = convert.numpy_spot_find_result(
            port_detect.detect_and_fit_batch(torch.from_numpy(imgs),
                                             max_candidates=k,
                                             num_iters=20))
    for chunk in (48, 200):
        res = port_detect.detect_and_fit_exhaustive(
            torch.from_numpy(imgs), chunk=chunk, num_iters=20)
        np.testing.assert_array_equal(res.cand_count, single.cand_count)
        n = min(res.keep.shape[1], k)
        assert not res.keep[:, n:].any() and not single.keep[:, n:].any()
        for name in port_detect.SpotFindResult._fields[:-1]:
            a, b = getattr(res, name)[:, :n], getattr(single, name)[:, :n]
            v = single.cand_valid[:, :n]
            np.testing.assert_array_equal(a[v], b[v], err_msg=name)
    # max_chunks bounds the rounds, loudly.
    with caplog.at_level(logging.WARNING):
        capped = port_detect.detect_and_fit_exhaustive(
            imgs, chunk=48, max_chunks=2, num_iters=5, device="cpu")
    assert capped.keep.shape[1] == 96
    assert any("max_chunks=2" in r.message for r in caplog.records)
    np.testing.assert_array_equal(capped.cand_count, got.cand_count)


@pytest.mark.parametrize("max_candidates", [None, 512])
def test_find_peptides_matches_jax(max_candidates):
    img = _field(4)
    ref = jax_detect.find_peptides(img, max_candidates=max_candidates,
                                   num_iters=30)
    got = port_detect.find_peptides(img, max_candidates=max_candidates,
                                    num_iters=30, device="cpu")
    _assert_psfs_parity(got, ref, img)
    # Raw camera integers: sub_img is the int64 copy of the input's patch.
    u16 = np.clip(img, 0, 65535).astype(np.uint16)
    got16 = port_detect.find_peptides(u16, max_candidates=max_candidates,
                                      num_iters=30, device="cpu")
    ref16 = jax_detect.find_peptides(u16, max_candidates=max_candidates,
                                     num_iters=30)
    _assert_psfs_parity(got16, ref16, u16)


@pytest.mark.parametrize("max_candidates", [None, 512])
def test_find_peptide_centers_matches_jax(max_candidates):
    img = _field(5, n_spots=10)
    rh, rw, rfits, rcount = jax_detect.find_peptide_centers(
        jnp.asarray(img), max_candidates=max_candidates, num_iters=30,
        gather_strategy="gather")
    h0, w0, fits, count = port_detect.find_peptide_centers(
        img, max_candidates=max_candidates, num_iters=30, device="cpu")
    np.testing.assert_array_equal(h0, rh)
    np.testing.assert_array_equal(w0, rw)
    assert count == rcount and len(fits) == len(rfits) > 0
    for g, r in zip(fits, rfits):
        np.testing.assert_allclose(g[:2], r[:2], atol=CENTER_ATOL)
        np.testing.assert_allclose(g[2:6], r[2:6], **FLOAT_TOL)
    psfs = port_detect.find_peptides(img, max_candidates=max_candidates,
                                     num_iters=30, device="cpu")
    assert list(psfs) == list(zip(h0.tolist(), w0.tolist()))


@pytest.mark.parametrize("max_candidates", [None, 512])
def test_find_peptides_batch_matches_jax_and_single_images(max_candidates):
    imgs = np.stack([_field(6), _field(7, n_spots=8)])
    ref = jax_detect.find_peptides_batch(imgs, max_candidates=max_candidates,
                                         num_iters=30, **JAX_KW)
    got = port_detect.find_peptides_batch(imgs, max_candidates=max_candidates,
                                          num_iters=30, device="cpu")
    assert len(got) == 2
    for b in range(2):
        _assert_psfs_parity(got[b], ref[b], imgs[b])
        one = port_detect.find_peptides(imgs[b],
                                        max_candidates=max_candidates,
                                        num_iters=30, device="cpu")
        assert list(one) == list(got[b])
        for key in one:
            for a, c in zip(one[key], got[b][key]):
                np.testing.assert_array_equal(a, c)


def test_psfs_from_arrays_on_shared_arrays_matches_jax():
    img = _field(12)
    res = convert.numpy_spot_find_result(port_detect.detect_and_fit(
        img, max_candidates=256, num_iters=20, device="cpu"))
    idx = np.nonzero(res.keep)[0]
    # A duplicate of a kept fit later in candidate order rounds to the
    # same key: the first occurrence wins (dict.setdefault).
    idx = np.concatenate([idx, idx[:1]])
    args = (img, idx, res.params, res.center_h, res.center_w, res.rmse,
            res.r2, res.s_n, res.cand_h, res.cand_w)
    got = port_detect._psfs_from_arrays(*args)
    ref = jax_detect._psfs_from_arrays(*args)
    assert list(got) == list(ref) and len(got) == len(idx) - 1 > 0
    for key, r in ref.items():
        g = got[key]
        assert g[:7] == r[:7] and g[9:] == r[9:]
        np.testing.assert_array_equal(g[7], r[7])
        assert g[8].dtype == np.float32 and r[8].dtype == np.float64
        np.testing.assert_allclose(g[8], r[8], rtol=1e-5)
    h0, w0, fits = port_detect._center_keys(idx, res.center_h, res.center_w,
                                            res.params)
    rh0, rw0, rfits = jax_detect._center_keys(idx, res.center_h,
                                              res.center_w, res.params)
    assert list(zip(h0, w0)) == list(got) == list(zip(rh0, rw0))
    assert fits == rfits
    assert port_detect._psfs_from_arrays(img, idx[:0], *args[2:]) == {}


def test_find_peptides_warns_and_raises(caplog, monkeypatch):
    img = _field(8, 64, 64, n_spots=6)
    with caplog.at_level(logging.WARNING):
        port_detect.find_peptides(img, max_candidates=16, num_iters=3,
                                  device="cpu")
        port_detect.find_peptide_centers(img, max_candidates=16,
                                         num_iters=3, device="cpu")
        port_detect.find_peptides_batch(img[None], max_candidates=16,
                                        num_iters=3, device="cpu")
        port_detect.find_peptides(img, max_candidates=512, num_iters=3,
                                  candidate_pixels=[(3, 3)], device="cpu")
    said = [r.message for r in caplog.records]
    assert sum("exceed max_candidates=16" in m for m in said) == 3
    assert any("candidate_pixels is ignored" in m for m in said)
    for fn in (port_detect.find_peptides, port_detect.find_peptide_centers,
               port_detect.find_peptides_batch):
        with pytest.raises(ValueError, match="consolidation_radius"):
            fn(img[None] if fn is port_detect.find_peptides_batch else img,
               consolidation_radius=1.5, device="cpu")
    for bad in (np.ones((5, 3)), np.ones((4, 4))):
        with pytest.raises(ValueError, match="square"):
            port_detect.find_peptides(img, correlation_matrix=bad,
                                      device="cpu")
        with pytest.raises(ValueError, match="square"):
            jax_detect.find_peptides(img, correlation_matrix=bad)
    # fit_type="monte_carlo" runs: on the JAX package's draws its psfs are
    # the JAX package's (tests/test_torch_mc_detect.py holds it in full).
    kw = dict(fit_type="monte_carlo", N_iter=20, max_candidates=128,
              rng_seed=1)
    z = np.stack([np.asarray(jax.random.normal(k, (20, 128), jnp.float32))
                  for k in jax.random.split(jax.random.PRNGKey(1), 6)])
    monkeypatch.setattr(port_detect, "draw_mc_normals",
                        lambda *a: torch.from_numpy(z))
    got = port_detect.find_peptides(img, device="cpu", **kw)
    want = jax_detect.find_peptides(img, **kw)
    assert list(got) == list(want) and len(got) >= 4
    for key in want:
        np.testing.assert_allclose(got[key][:7], want[key][:7], rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="fit_type"):
        port_detect.find_peptides(img, fit_type="other", device="cpu")
    # The card is the default device: without one, the entry points raise.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_detect.find_peptides(img)


def test_detect_and_fit_single_image_matches_jax():
    img = _field(9)
    ref = jax_detect.detect_and_fit(jnp.asarray(img), max_candidates=256,
                                    num_iters=20, **JAX_KW)
    got = port_detect.detect_and_fit(img, max_candidates=256, num_iters=20,
                                     device="cpu")
    assert got.keep.shape == (256,) and got.cand_count.ndim == 0
    _assert_result_parity(convert.numpy_spot_find_result(got), ref)


def test_pack_spot_buckets_matches_jax_on_an_overflowing_result():
    imgs = np.stack([_field(10, n_spots=14), _field(11, n_spots=12)])
    ref = jax_detect.detect_and_fit_batch(
        jnp.asarray(imgs), max_candidates=256, num_iters=20, **JAX_KW)
    max_spots = 8
    assert int(np.asarray(ref.keep).sum(axis=1).min()) > max_spots
    want = jax_detect.pack_spot_buckets(ref, max_spots)
    res = convert.spot_find_result(ref)
    assert res.cand_count.dtype == torch.int32
    got = port_detect.pack_spot_buckets(res, max_spots)
    for g, w, dt in zip(got, want, (torch.float32, torch.int16, torch.bool,
                                    torch.int32, torch.int32)):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    wide = port_detect.pack_spot_buckets(res, max_spots,
                                         coord_dtype=torch.int32)
    assert wide[1].dtype == torch.int32
    un = port_detect.unpack_spot_buckets(*(g.numpy() for g in got))
    un_ref = jax_detect.unpack_spot_buckets(*want)
    assert list(un) == list(un_ref)
    for k in un_ref:
        np.testing.assert_array_equal(un[k], un_ref[k], err_msg=k)
    assert un["keep"].all() and (un["spot_count"] > max_spots).all()
    # Kept slots carry the full schema's values, in candidate order.
    back = convert.numpy_spot_find_result(res, jax_detect.SpotFindResult)
    for b in range(2):
        first = np.nonzero(back.keep[b])[0][:max_spots]
        np.testing.assert_array_equal(un["center_h"][b],
                                      back.center_h[b][first])
        np.testing.assert_array_equal(un["params"][b], back.params[b][first])
        np.testing.assert_array_equal(un["cand_h"][b], back.cand_h[b][first])
    # A bucket wider than the candidate bucket returns every slot.
    assert port_detect.pack_spot_buckets(res, 1000)[0].shape == (2, 256, 12)


def test_config_and_result_converters():
    from fluorosequencingimageanalysis_tpu import config as jax_config
    from fluorosequencingimageanalysis_torch import config as port_config
    jcfg = jax_config.PipelineConfig(
        detect=jax_config.DetectConfig(c_std=3.0, max_candidates=77),
        photometry=jax_config.PhotometryConfig(method="sextractor",
                                               aperture_radius=2.5))
    cfg = convert.port_config(jcfg)
    assert isinstance(cfg, port_config.PipelineConfig)
    assert isinstance(cfg.detect, port_config.DetectConfig)
    assert cfg.asdict() == jcfg.asdict()
    assert convert.port_config(jcfg.detect) == cfg.detect
    assert convert.port_config(cfg) == cfg
