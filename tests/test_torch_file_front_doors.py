"""The port's file front doors on a machine without imageio, on the CPU.

The card's machine has no imageio, so here ``imageio`` is blocked in
``sys.modules`` while the port runs, and the port reads every image with
its own decoders (utils/imageio.py). The JAX package's side runs with
imageio, on the same files. Held as in tests/test_torch_cli.py,
tests/test_torch_experiment.py and tests/test_torch_compat.py:

- ``run-experiment`` on a directory a cycle of uncompressed TIFFs: its
  track and category CSVs byte-equal to the port's ``run_experiment`` on
  the array, and its rows the JAX CLI's (keys, categories and order equal;
  photometry within rtol 1e-4, atol 5e-2);
- ``zstack`` on one multi-page TIFF: the CSV's rows the API's kept fits on
  the array, and the JAX CLI's (frames equal, centers within 1e-3 px, the
  other floats, theta apart, within rtol 5e-3, atol 5e-3);
- ``timetrace`` on per-frame PNGs (written through imageio, with PNG's row
  filters) and on one multi-page TIFF: the JAX CLI's CSV (text cells equal,
  numbers within rel 1e-5 / abs 1e-2), and the two CSVs byte-equal;
- ``detect`` on a TIFF: the JAX package's psfs artifacts (keys and order
  equal, centers within 1e-3 px, the other floats within rtol 5e-3,
  atol 5e-3, the PNG byte-equal);
- ``compat.basic_timetrace_script`` on per-frame PNGs: the root script's
  CSV (photometry within rtol 1e-5, atol 1e-2) and step fits.
"""

import ast
import csv
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_tpu import batch as jax_batch
from fluorosequencingimageanalysis_tpu.__main__ import main as jax_main

from fluorosequencingimageanalysis_torch import _device
from fluorosequencingimageanalysis_torch.__main__ import main
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.compat import (
    basic_timetrace_script as port_tt_app)
from fluorosequencingimageanalysis_torch.config import (DetectConfig,
                                                        PipelineConfig)
from fluorosequencingimageanalysis_torch.utils import imageio as port_io
from fluorosequencingimageanalysis_torch.utils import synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

iio = pytest.importorskip("imageio.v2")
CENTER_ATOL = 1e-3
FLOAT_TOL = dict(rtol=5e-3, atol=5e-3)
EXP_PHOT_RTOL, EXP_PHOT_ATOL = 1e-4, 5e-2
APP_PHOT_RTOL, APP_PHOT_ATOL = 1e-5, 1e-2


def _block_imageio(monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError):
        import imageio.v2  # noqa: F401


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _rows(path, **kw):
    with open(path, newline="") as fh:
        return list(csv.reader(fh, **kw))


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_run_experiment_from_tiff_files(tmp_path, capsys, monkeypatch):
    stack = np.clip(synth.make_experiment_stack(2, 2, 96, 96,
                                                spots_per_field=10),
                    0, 65535).astype(np.uint16)
    files = []
    for c in range(2):
        (tmp_path / f"cycle_{c}").mkdir()
        for f in range(2):
            files.append(str(tmp_path / f"cycle_{c}" / f"field_{f}.tif"))
            port_io.write_tiff(files[-1], stack[f, c])
    argv = ["run-experiment", "--peptide-files", *files,
            "--max-candidates", "128"]
    assert jax_main([*argv, "--output-dir", str(tmp_path / "jax")]) == 0
    ref = _json_line(capsys)
    _block_imageio(monkeypatch)
    assert main([*argv, "--output-dir", str(tmp_path / "port"),
                 "--device", "cpu"]) == 0
    got = _json_line(capsys)
    assert sorted(got) == sorted(ref)
    assert (got["fields"], got["cycles"], got["rows"]) == \
        (2, 2, ref["rows"])
    # The files hold the array: byte-equal to run_experiment on it.
    csv_path, cat_path = str(tmp_path / "a.csv"), str(tmp_path / "c.csv")
    Pipeline(device="cpu").run_experiment(
        stack, csv_path=csv_path, category_csv_path=cat_path,
        max_candidates=128)
    assert _read(got["csv"]) == _read(csv_path)
    assert _read(got["category_csv"]) == _read(cat_path)
    rows, ref_rows = _rows(got["csv"]), _rows(ref["csv"])
    assert rows[0] == ref_rows[0] and len(rows) == len(ref_rows) > 1
    for r, w in zip(rows[1:], ref_rows[1:]):
        assert r[:5] == w[:5]
        np.testing.assert_allclose(np.asarray(r[5:], float),
                                   np.asarray(w[5:], float),
                                   rtol=EXP_PHOT_RTOL, atol=EXP_PHOT_ATOL)
    assert _rows(got["category_csv"]) == _rows(ref["category_csv"])


def test_zstack_from_a_multi_page_tiff(tmp_path, capsys, monkeypatch):
    stack = synth.make_zstack(3, 96, 96, n_spots=12)
    tif = str(tmp_path / "frames.tif")
    port_io.write_tiff(tif, stack, compression="deflate", predictor=True)
    flags = ["--box-size", "16", "--filter-size", "3", "--max-candidates",
             "256"]
    ref_csv, out_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    assert jax_main(["zstack", tif, "--output", ref_csv, *flags]) == 0
    ref = _json_line(capsys)
    _block_imageio(monkeypatch)
    assert main(["zstack", tif, "--output", out_csv, *flags, "--device",
                 "cpu"]) == 0
    got = _json_line(capsys)
    assert got["frames"] == ref["frames"] == 3
    api = Pipeline(PipelineConfig(detect=DetectConfig(max_candidates=256)),
                   device="cpu").run_zstack(stack, box_size=16,
                                            filter_size=3)
    rows = _rows(out_csv)
    assert [r[:3] for r in rows[1:]] == [
        [str(t), str(api["center_h"][t, i]), str(api["center_w"][t, i])]
        for t in range(3) for i in np.nonzero(api["keep"][t])[0]]
    ref_rows = _rows(ref_csv)
    assert rows[0] == ref_rows[0] and len(rows) == len(ref_rows) > 24
    theta = rows[0].index("THETA")
    for r, w in zip(rows[1:], ref_rows[1:]):
        assert r[0] == w[0]
        np.testing.assert_allclose(np.asarray(r[1:3], float),
                                   np.asarray(w[1:3], float),
                                   atol=CENTER_ATOL)
        keep = [i for i in range(3, len(r)) if i != theta]
        np.testing.assert_allclose([float(r[i]) for i in keep],
                                   [float(w[i]) for i in keep], **FLOAT_TOL)


def _assert_csvs_close(got_path, ref_path):
    got, ref = _rows(got_path), _rows(ref_path)
    assert got[0] == ref[0] and len(got) == len(ref) > 1
    for g, r in zip(got[1:], ref[1:]):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            try:
                fb = float(b)
            except ValueError:
                assert a == b
            else:
                assert float(a) == pytest.approx(fb, rel=1e-5, abs=1e-2)


def test_timetrace_from_png_frames_and_a_multi_page_tiff(tmp_path, capsys,
                                                         monkeypatch):
    movie = synth.make_movie(T=12, H=96, W=96, n_spots=10, seed=1)
    frames = []
    for f in range(12):
        frames.append(str(tmp_path / f"frame_{f:02d}.png"))
        iio.imwrite(frames[-1], movie[f])
    tif = str(tmp_path / "movie.tif")
    port_io.write_tiff(tif, movie, compression="lzw", predictor=True)
    flags = ["--max-candidates", "256", "--mirror-start", "10",
             "--chung-kennedy", "1", "--p-threshold", "0.01",
             "--photometry-method", "simple"]
    assert jax_main(["timetrace", "--frames", *frames, *flags,
                     "--output-dir", str(tmp_path / "jax")]) == 0
    ref = _json_line(capsys)
    _block_imageio(monkeypatch)
    assert main(["timetrace", "--frames", *frames, *flags, "--output-dir",
                 str(tmp_path / "png"), "--device", "cpu"]) == 0
    got = _json_line(capsys)
    assert (got["frames"], got["traces"]) == (12, ref["traces"]) and \
        got["traces"] >= 8
    _assert_csvs_close(got["csv"], ref["csv"])
    assert main(["timetrace", "--frames", tif, *flags, "--output-dir",
                 str(tmp_path / "tif"), "--device", "cpu"]) == 0
    assert _read(_json_line(capsys)["csv"]) == _read(got["csv"])


def test_detect_from_a_tiff(tmp_path, capsys, monkeypatch):
    stack, _ = synth.make_stack(1, 1, 80, 80, spots_per_field=8, seed=3)
    field = np.clip(stack[0, 0], 0, 65535).astype(np.uint16)
    images = {}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        images[name] = str(tmp_path / name / "field.tif")
        port_io.write_tiff(images[name], field, compression="packbits")
    ref_out = jax_batch.image_batch([images["jax"]])[images["jax"]]
    _block_imageio(monkeypatch)
    assert main(["detect", images["port"], "--device", "cpu"]) == 0
    summary = _json_line(capsys)
    assert summary["images"] == summary["processed"] == 1
    pkl, csv_path, png = summary["artifacts"][images["port"]]
    with open(pkl, "rb") as fh:
        got = pickle.load(fh)
    with open(ref_out[1], "rb") as fh:
        ref = pickle.load(fh)
    assert list(got) == list(ref) and len(ref) >= 6
    for key, r in ref.items():
        g = got[key]
        np.testing.assert_allclose(g[:2], r[:2], atol=CENTER_ATOL)
        np.testing.assert_allclose(g[2:6], r[2:6], **FLOAT_TOL)
        np.testing.assert_allclose(g[9:], r[9:], **FLOAT_TOL)
        np.testing.assert_array_equal(g[7], r[7])
    rows = _rows(csv_path, dialect="excel-tab")
    assert rows[0] == _rows(ref_out[2], dialect="excel-tab")[0]
    assert len(rows) == len(got) + 1
    assert _read(png) == _read(ref_out[3])


def test_basic_timetrace_script_from_png_frames(tmp_path, monkeypatch):
    from test_apps import _write_field_png

    import basic_timetrace_script
    monkeypatch.setattr(_device, "_DEFAULT", None)
    monkeypatch.setenv("FSIA_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(2)
    frames = []
    for f in range(12):
        coords = [(30, 30), (60, 70)] if f < 6 else [(60, 70)]
        frames.append(str(tmp_path / f"frame_{f:03d}.png"))
        _write_field_png(frames[-1], coords, rng=rng)
    monkeypatch.chdir(tmp_path)
    res = {}
    for name, app in (("root", basic_timetrace_script.main),
                      ("port", port_tt_app.main)):
        out = tmp_path / name
        argv = ["--output_directory", str(out), "--no_sanity_check_images",
                "--save_traces_pkl", "-L", str(tmp_path / f"log_{name}")]
        if name == "port":
            _block_imageio(monkeypatch)
            argv += ["--device", "cpu"]
        app(argv + frames)
        with open(out / "test.pkl", "rb") as fh:
            res[name] = (_rows(out / "test.csv"), pickle.load(fh))
    (rr, (fr, ir)), (rp, (fp, ip)) = res["root"], res["port"]
    assert rp[0] == rr[0] and len(rp) == len(rr) == 2 * 12 + 1
    for a, b in zip(rp[1:], rr[1:]):
        assert a[:4] == b[:4] and a[5] == b[5]
        for x, y in zip(a[4:], b[4:]):
            if x == "None" or y == "None":
                assert x == y
                continue
            np.testing.assert_allclose(
                np.asarray(ast.literal_eval(x), float),
                np.asarray(ast.literal_eval(y), float),
                rtol=APP_PHOT_RTOL, atol=APP_PHOT_ATOL)
    assert fp.keys() == fr.keys() and ip.keys() == ir.keys()
    for k in fr:
        assert [p[:2] for p in fp[k].trace] == [p[:2] for p in fr[k].trace]
    assert os.path.exists(tmp_path / "port" / "traces.pkl")
