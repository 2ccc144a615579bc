"""The port's CLI (``python -m fluorosequencingimageanalysis_torch``) and
its file front door (batch.py), on the CPU, against the JAX package's.

``detect`` on a planted field written as a .tif must write the pkl/csv/png
artifacts of the JAX package's ``batch.image_batch``: equal psfs keys in
equal order, equal ``sub_img``, centers within 1e-3 px, the other floats
(theta apart) within rtol 5e-3, atol 5e-3, and a byte-equal PNG. ``zstack``
on a .npy and ``run-experiment`` on a two-cycle directory print the JAX
CLI's JSON summary (same keys) and write CSVs whose rows are the API's.
``stepfit`` (from an .npy matrix and from a track CSV, both methods) and
``timetrace`` (on TIFF frames) print the JAX CLI's summary and write its
CSV: text cells equal, numbers within rel 1e-5 / abs 1e-2.
``fluor-counts`` (manual and ``--auto-calibrate``), ``background-correct``
and ``remainder-correct`` print the JAX CLI's summary and write its files:
signals pickles and calibrations equal, corrected CSVs byte-equal.
"""

import argparse
import csv
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluorosequencingimageanalysis_tpu import batch as jax_batch
from fluorosequencingimageanalysis_tpu.__main__ import (
    build_parser as jax_build_parser)
from fluorosequencingimageanalysis_tpu.__main__ import main as jax_main

from fluorosequencingimageanalysis_torch import batch as port_batch
from fluorosequencingimageanalysis_torch.__main__ import build_parser, main
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (DetectConfig,
                                                        PhotometryConfig,
                                                        PipelineConfig,
                                                        StepfitConfig)
from fluorosequencingimageanalysis_torch.models import detect as port_detect
from fluorosequencingimageanalysis_torch.sim import dye_sim as port_sim
from fluorosequencingimageanalysis_torch.utils import synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

iio = pytest.importorskip("imageio.v2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTER_ATOL = 1e-3
FLOAT_TOL = dict(rtol=5e-3, atol=5e-3)


def _planted(seed, H=80, W=80, n=8):
    stack, _ = synth.make_stack(1, 1, H, W, spots_per_field=n, seed=seed)
    return np.clip(stack[0, 0], 0, 65535).astype(np.uint16)


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_psfs_close(got, ref):
    assert list(got) == list(ref) and len(ref) > 0
    for key, r in ref.items():
        g = got[key]
        np.testing.assert_allclose(g[:2], r[:2], atol=CENTER_ATOL)
        np.testing.assert_allclose(g[2:6], r[2:6], **FLOAT_TOL)
        np.testing.assert_allclose(g[9:], r[9:], **FLOAT_TOL)
        np.testing.assert_array_equal(g[7], r[7])
        assert g[8].shape == (5, 5)


def test_detect_writes_the_jax_packages_artifacts(tmp_path, capsys):
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        iio.imwrite(tmp_path / name / "field.tif", _planted(3))
    image = str(tmp_path / "port" / "field.tif")
    assert main(["detect", image, "--device", "cpu"]) == 0
    summary = _json_line(capsys)
    assert summary["images"] == summary["processed"] == 1
    pkl, csv_path, png = summary["artifacts"][image]
    assert pkl.startswith(image + "_psfs_") and pkl.endswith(".pkl")
    with open(pkl, "rb") as fh:
        got = pickle.load(fh)
    assert summary["spots"][image] == len(got) >= 6
    ref_image = str(tmp_path / "jax" / "field.tif")
    ref_out = jax_batch.image_batch([ref_image])[ref_image]
    with open(ref_out[1], "rb") as fh:
        ref = pickle.load(fh)
    _assert_psfs_close(got, ref)
    with open(csv_path, newline="") as fh:
        rows = list(csv.reader(fh, dialect="excel-tab"))
    with open(ref_out[2], newline="") as fh:
        ref_rows = list(csv.reader(fh, dialect="excel-tab"))
    assert rows[0] == ref_rows[0] and len(rows) == len(ref_rows) == \
        len(got) + 1
    assert [r[0] for r in rows[1:]] == [image] * len(got)
    for r, (h0, w0, *_rest) in zip(rows[1:], got.values()):
        assert (r[1], r[2]) == (str(h0), str(w0))
    with open(png, "rb") as a, open(ref_out[3], "rb") as b:
        assert a.read() == b.read()         # same keys, same squares
    # Flags reach find_peptides; a capped bucket warns and keeps fewer.
    assert main(["detect", image, "--device", "cpu", "--max-candidates",
                 "512", "--c-std", "4", "--r2-threshold", "0.9"]) == 0
    strict = _json_line(capsys)
    assert 0 < strict["spots"][image] <= len(got)
    # A missing image is skipped and turns the exit code.
    assert main(["detect", str(tmp_path / "nope.tif"), "--device",
                 "cpu"]) == 1
    assert _json_line(capsys)["processed"] == 0


def test_batch_runners_match_the_jax_packages(tmp_path, monkeypatch):
    paths = {}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        paths[name] = []
        for i, shape in enumerate([(64, 64), (64, 64), (48, 72)]):
            p = str(tmp_path / name / f"f{i}.tif")
            iio.imwrite(p, _planted(10 + i, *shape, n=5))
            paths[name].append(p)
    kw = dict(find_peptides_parameters={"num_iters": 30}, timestamp_epoch=77)
    got = port_batch.parallel_image_batch(
        paths["port"], find_peptides_parameters={
            "num_iters": 30, "device": "cpu", "fit_type": "gauss"},
        timestamp_epoch=77, num_processes=3)
    ref = jax_batch.parallel_image_batch(paths["jax"], **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref]
    for (p, g), r in zip(got.items(), ref.values()):
        assert g[0] == p and [os.path.basename(x) for x in g[1:]] == \
            [os.path.basename(x) for x in r[1:]]
        with open(g[1], "rb") as a, open(r[1], "rb") as b:
            psfs = pickle.load(a)
            _assert_psfs_close(psfs, pickle.load(b))
        one = port_batch.image_batch(
            [p], find_peptides_parameters={"num_iters": 30,
                                           "device": "cpu"},
            timestamp_epoch=78)[p]
        with open(one[1], "rb") as fh:
            single = pickle.load(fh)
        assert list(single) == list(psfs)
        out = port_batch.save_psfs_csv(psfs, output_path=str(
            tmp_path / "x.csv"))
        assert out.endswith("x.csv")
    with pytest.raises(ValueError, match="image_path or output_path"):
        port_batch.save_psfs_pkl({})
    # monte_carlo takes the per-image runner; on the JAX package's draws
    # its artifacts hold the JAX package's psfs.
    mc = {"fit_type": "monte_carlo", "N_iter": 20, "max_candidates": 128}
    z = np.stack([np.asarray(jax.random.normal(k, (20, 128), jnp.float32))
                  for k in jax.random.split(jax.random.PRNGKey(0), 6)])
    monkeypatch.setattr(port_detect, "draw_mc_normals",
                        lambda *a: torch.from_numpy(z))
    got = port_batch.parallel_image_batch(
        paths["port"][:1], find_peptides_parameters={**mc, "device": "cpu"},
        timestamp_epoch=79)
    ref = jax_batch.parallel_image_batch(
        paths["jax"][:1], find_peptides_parameters=mc, timestamp_epoch=79)
    assert len(got) == len(ref) == 1
    with open(next(iter(got.values()))[1], "rb") as a, \
            open(next(iter(ref.values()))[1], "rb") as b:
        psfs, want = pickle.load(a), pickle.load(b)
    assert list(psfs) == list(want) and len(want) >= 3
    for key in want:
        np.testing.assert_allclose(psfs[key][:7], want[key][:7], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(psfs[key][7], want[key][7])


def test_zstack_cli_rows_are_the_apis_kept_fits(tmp_path, capsys):
    stack = synth.make_zstack(3, 96, 96, n_spots=12)
    npy = str(tmp_path / "frames.npy")
    np.save(npy, stack)
    out_csv = str(tmp_path / "spots.csv")
    bg_npy = str(tmp_path / "bg.npy")
    argv = ["zstack", npy, "--output", out_csv, "--box-size", "16",
            "--filter-size", "3", "--max-candidates", "256",
            "--background-npy", bg_npy, "--store", str(tmp_path / "store"),
            "--device", "cpu"]
    assert main(argv) == 0
    summary = _json_line(capsys)
    assert sorted(summary) == ["background_npy", "candidates_per_frame",
                               "frames", "output", "spots"]
    api_out = Pipeline(PipelineConfig(detect=DetectConfig(
        max_candidates=256)), device="cpu").run_zstack(
            stack, box_size=16, filter_size=3, return_background=True)
    assert summary["frames"] == 3
    assert summary["spots"] == int(api_out["keep"].sum()) >= 24
    assert summary["candidates_per_frame"] == api_out["cand_count"].tolist()
    with open(out_csv, newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["FRAME", "H", "W", "AMPLITUDE", "SIGMA_H", "SIGMA_W",
                       "THETA", "RMSE", "R_2", "S_N"]
    want = [[str(t), str(api_out["center_h"][t, i]),
             str(api_out["center_w"][t, i])]
            for t in range(3) for i in np.nonzero(api_out["keep"][t])[0]]
    assert [r[:3] for r in rows[1:]] == want
    np.testing.assert_array_equal(np.load(bg_npy), api_out["background"])
    assert main(argv) == 0                  # second run: from the store
    assert _json_line(capsys)["spots"] == summary["spots"]
    np.save(npy, stack[0])
    with pytest.raises(SystemExit, match="T, H, W"):
        main(["zstack", npy, "--device", "cpu"])
    # The module entry point, as a user runs it.
    np.save(npy, stack[:1])
    proc = subprocess.run(
        [sys.executable, "-m", "fluorosequencingimageanalysis_torch",
         "zstack", npy, "--output", out_csv, "--max-candidates", "128",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["frames"] == 1


def test_run_experiment_cli_on_a_two_cycle_directory(tmp_path, capsys):
    stack = synth.make_experiment_stack(2, 2, 96, 96, spots_per_field=10)
    stack = np.clip(stack, 0, 65535).astype(np.uint16)
    files = []
    for c in range(2):
        d = tmp_path / f"cycle_{c}"
        d.mkdir()
        for f in range(2):
            files.append(str(d / f"field_{f}.tif"))
            iio.imwrite(files[-1], stack[f, c])
    out_dir = str(tmp_path / "out")
    assert main(["run-experiment", "--peptide-files", *files,
                 "--output-dir", out_dir, "--max-candidates", "128",
                 "--photometry-method", "sextractor", "--detect-parameters",
                 "{'num_iters': 30}", "--offsets-pkl", "offsets.pkl",
                 "--all-categories", "--profile", "--device", "cpu"]) == 0
    summary = _json_line(capsys)
    assert sorted(summary) == ["category_csv", "channels", "csv", "cycles",
                               "fields", "rows", "stages_sec", "summary"]
    assert (summary["fields"], summary["cycles"]) == (2, 2)
    assert summary["channels"] == ["ch1"] and summary["rows"] > 0
    assert "api/run_stack" in summary["stages_sec"]
    cfg = PipelineConfig(
        detect=DetectConfig(num_iters=30),
        photometry=PhotometryConfig(method="sextractor"))
    want = Pipeline(cfg, device="cpu").run_experiment(stack,
                                                      max_candidates=128)
    with open(summary["csv"], newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["CHANNEL", "FIELD", "H", "W", "CATEGORY", "FRAME 0",
                       "FRAME 1"]
    assert len(rows) == len(want["rows"]) + 1 == summary["rows"] + 1
    for r, w in zip(rows[1:], want["rows"]):
        assert r[:5] == [str(x) for x in w[:5]]
        assert r[5:] == [str(v) for v in w[5]]
    with open(summary["category_csv"], newline="") as fh:
        assert next(csv.reader(fh)) == ["Pattern", "Channel", "Count"]
    with open(os.path.join(out_dir, "offsets.pkl"), "rb") as fh:
        offsets = pickle.load(fh)
    np.testing.assert_array_equal(offsets["ch1"][0], want["offsets"]["ch1"][0])
    with pytest.raises(SystemExit, match="same number"):
        main(["run-experiment", "--peptide-files", *files[:3],
              "--output-dir", out_dir, "--device", "cpu"])


def _csv_rows(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _assert_csvs_close(got_path, ref_path):
    got, ref = _csv_rows(got_path), _csv_rows(ref_path)
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
    return got


@pytest.mark.parametrize("method", ["t_test", "chi_squared"])
def test_stepfit_cli_from_npy_matches_the_jax_cli_and_the_api(
        method, tmp_path, capsys):
    phot = synth.make_step_traces(24, 60, seed=5)
    npy = str(tmp_path / "phot.npy")
    np.save(npy, phot)
    flags = ["--mirror-start", "10", "--chung-kennedy", "1"] \
        if method == "t_test" else ["--chung-kennedy", "1", "--num-steps",
                                    "6"]
    argv = ["stepfit", "--npy", npy, "--method", method, *flags]
    assert main([*argv, "--output-dir", str(tmp_path / "port"), "--device",
                 "cpu"]) == 0
    summary = _json_line(capsys)
    assert jax_main([*argv, "--output-dir", str(tmp_path / "jax")]) == 0
    ref = _json_line(capsys)
    assert sorted(summary) == sorted(ref) == ["csv", "steps", "traces"]
    assert (summary["traces"], summary["steps"]) == (24, ref["steps"])
    rows = _assert_csvs_close(summary["csv"], ref["csv"])
    assert len(rows) == 1 + 24 * 60 and summary["steps"] > 24
    if method == "t_test":
        fits = Pipeline(PipelineConfig(stepfit=StepfitConfig(
            mirror_start=10, chung_kennedy=1, p_threshold=0.01)),
            device="cpu").stepfit(phot)
        assert summary["steps"] == sum(len(f[3]) - 1 for f in fits)
        first = [r for r in rows[1:] if r[0] == "0"]
        assert [float(r[8]) for r in first] == [
            h for a, b, h in fits[0][3] for _ in range(a, b + 1)]
    else:
        with pytest.raises(SystemExit, match="mirror_start"):
            main([*argv, "--mirror-start", "5", "--device", "cpu"])
    with pytest.raises(SystemExit, match="exactly one"):
        main(["stepfit", "--device", "cpu"])
    np.save(npy, phot[0])
    with pytest.raises(SystemExit, match=r"\(N, T\)"):
        main(["stepfit", "--npy", npy, "--device", "cpu"])


def test_stepfit_cli_from_a_run_experiment_track_csv(tmp_path, capsys):
    stack = np.clip(synth.make_experiment_stack(
        2, 8, 96, 96, spots_per_field=10), 0, 65535).astype(np.uint16)
    tracks = str(tmp_path / "tracks.csv")
    res = Pipeline(device="cpu").run_experiment(stack, max_candidates=128,
                                                csv_path=tracks)
    argv = ["stepfit", tracks, "--channel", "ch1", "--p-threshold", "0.01"]
    assert main([*argv, "--output-dir", str(tmp_path / "port"), "--profile",
                 "--device", "cpu"]) == 0
    summary = _json_line(capsys)
    assert jax_main([*argv, "--output-dir", str(tmp_path / "jax")]) == 0
    ref = _json_line(capsys)
    assert summary["traces"] == ref["traces"] == len(res["rows"]) > 10
    assert summary["steps"] == ref["steps"]
    rows = _assert_csvs_close(summary["csv"], ref["csv"])
    assert rows[0][:6] == ["Trace #", "Channel", "Field", "Hcoord", "Wcoord",
                           "Frame #"]
    assert len(rows) == 1 + summary["traces"] * 8
    assert {r[1] for r in rows[1:]} == {"ch1"}
    with pytest.raises(SystemExit, match="no traces"):
        main(["stepfit", tracks, "--channel", "ch9", "--device", "cpu"])


def test_timetrace_cli_on_tiff_frames(tmp_path, capsys):
    movie = synth.make_movie(T=12, H=96, W=96, n_spots=10, seed=1)
    frames = []
    for f in range(12):
        frames.append(str(tmp_path / f"frame_{f:02d}.tif"))
        iio.imwrite(frames[-1], movie[f])
    argv = ["timetrace", "--frames", *frames, "--max-candidates", "256",
            "--mirror-start", "10", "--chung-kennedy", "1", "--p-threshold",
            "0.01", "--photometry-method", "simple"]
    assert main([*argv, "--output-dir", str(tmp_path / "port"), "--profile",
                 "--device", "cpu"]) == 0
    summary = _json_line(capsys)
    assert jax_main([*argv, "--output-dir", str(tmp_path / "jax")]) == 0
    ref = _json_line(capsys)
    assert sorted(summary) == ["csv", "frames", "stages_sec", "traces"]
    assert (summary["frames"], summary["traces"]) == (12, ref["traces"])
    assert summary["traces"] >= 8
    assert "api/run_timetrace/track+photometry" in summary["stages_sec"]
    rows = _assert_csvs_close(summary["csv"], ref["csv"])
    assert len(rows) == 1 + summary["traces"] * 12
    want = Pipeline(PipelineConfig(photometry=PhotometryConfig(
        method="simple")), device="cpu").run_timetrace(
            movie, max_candidates=256, mirror_start=10, chung_kennedy=1,
            p_threshold=0.01)
    assert [float(r[4]) for r in rows[1:13]] == list(want["photometries"][0])
    # One multi-page file is the same movie.
    iio.mimwrite(tmp_path / "movie.tif", list(movie))
    assert main(["timetrace", "--frames", str(tmp_path / "movie.tif"),
                 *argv[14:], "--output-dir", str(tmp_path / "multi"),
                 "--device", "cpu"]) == 0
    multi = _json_line(capsys)
    with open(multi["csv"]) as a, open(summary["csv"]) as b:
        assert a.read() == b.read()


def test_run_files_reads_the_stack_run_stack_takes(tmp_path):
    stack, _ = synth.make_stack(2, 2, 64, 64, spots_per_field=5, seed=3)
    stack = np.clip(stack, 0, 65535).astype(np.uint16)
    paths = [[str(tmp_path / f"c{c}_f{f}.tif") for f in range(2)]
             for c in range(2)]
    for c in range(2):
        for f in range(2):
            iio.imwrite(paths[c][f], stack[f, c])
    pipe = Pipeline(PipelineConfig(detect=DetectConfig(max_candidates=32,
                                                       num_iters=10)),
                    device="cpu")
    got, want = pipe.run_files(paths), pipe.run_stack(stack)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="same field count"):
        pipe.run_files([paths[0], paths[1][:1]])


def test_parser_has_the_ported_subcommands_and_the_cards_default(tmp_path):
    parser = build_parser()
    for argv in (["detect", "a.tif"], ["zstack", "a.npy"],
                 ["run-experiment", "--peptide-files", "a.tif"],
                 ["timetrace", "--frames", "a.tif"], ["stepfit", "a.csv"],
                 ["fluor-counts", "a.csv"], ["simulate", "ACK", "C"]):
        assert parser.parse_args(argv).device == "cuda"
    subcommands = [sorted(next(
        a for a in p._actions
        if isinstance(a, argparse._SubParsersAction)).choices)
        for p in (parser, jax_build_parser())]
    assert subcommands[0] == subcommands[1] and len(subcommands[0]) == 9
    args = parser.parse_args(["stepfit", "--npy", "p.npy"])
    assert (args.method, args.mirror_start, args.chung_kennedy,
            args.p_threshold, args.num_steps, args.csv) == (
                "t_test", 0, 0, 0.01, 10, "step_fits.csv")
    args = parser.parse_args(["timetrace", "--frames", "a.tif", "b.tif"])
    assert (args.search_radius, args.sn_cutoff, args.max_candidates,
            args.mirror_start, args.csv) == (3, 3.0, None, None,
                                             "timetrace.csv")
    args = parser.parse_args(["zstack", "a.npy"])
    assert (args.box_size, args.filter_size, args.output) == (
        10, 10, "zstack_spots.csv")
    if not torch.cuda.is_available():
        npy = str(tmp_path / "frames.npy")
        np.save(npy, np.zeros((1, 16, 16), np.uint16))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["zstack", npy])


def _pickle_at(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _ladder_csv(path, n=60, n_frames=5, channels=("ch1",), seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(n_frames)])
        for t in range(n):
            counts = [int(rng.integers(1, 3))]
            for _ in range(n_frames - 1):
                counts.append(max(counts[-1] - int(rng.random() < 0.4), 0))
            ints = [int(rng.lognormal(np.log(30000.0 * v), 0.2)) if v
                    else int(abs(rng.normal(300, 50))) for v in counts]
            w.writerow([channels[t % len(channels)], t % 2, 10 + t, 20,
                        str(tuple(v > 0 for v in counts))] + ints)


def test_fluor_counts_cli_on_a_run_experiment_track_csv(tmp_path, capsys):
    """run-experiment's track CSV chains into fluor-counts, as in the JAX
    package's CLI test; both CLIs count the same signals."""
    stack = np.clip(synth.make_experiment_stack(
        1, 4, 96, 96, spots_per_field=10), 0, 65535).astype(np.uint16)
    tracks = str(tmp_path / "tracks.csv")
    res = Pipeline(device="cpu").run_experiment(stack, max_candidates=128,
                                                csv_path=tracks)
    argv = ["fluor-counts", tracks, "--beta", "3000", "--beta-sigma", "0.3"]
    assert main([*argv, "--signals-pkl", str(tmp_path / "port.pkl"),
                 "--device", "cpu"]) == 0
    summary = _json_line(capsys)
    assert jax_main([*argv, "--signals-pkl", str(tmp_path / "jax.pkl")]) == 0
    ref = _json_line(capsys)
    assert sorted(summary) == sorted(ref) == [
        "calibration", "distinct_signals", "none", "signals_pkl", "traces"]
    assert summary["traces"] == ref["traces"] == len(res["rows"]) >= 8
    assert (summary["none"], summary["distinct_signals"],
            summary["calibration"]) == (ref["none"], ref["distinct_signals"],
                                        None)
    assert _pickle_at(tmp_path / "port.pkl") == _pickle_at(tmp_path /
                                                           "jax.pkl")
    with pytest.raises(SystemExit, match="--beta is required"):
        main(["fluor-counts", tracks, "--device", "cpu"])


def test_fluor_counts_cli_flags_match_the_jax_cli(tmp_path, capsys):
    tracks = str(tmp_path / "tracks.csv")
    _ladder_csv(tracks, channels=("ch1", "ch2"))
    with pytest.raises(NotImplementedError, match="channels"):
        main(["fluor-counts", tracks, "--beta", "30000", "--device", "cpu"])
    for extra in (["--channel", "ch1"],
                  ["--channel", "ch2", "--alpha-adjust", "150",
                   "--max-possible", "3", "--no-multidrop"]):
        argv = ["fluor-counts", tracks, "--beta", "30000", *extra]
        assert main([*argv, "--signals-pkl", str(tmp_path / "port.pkl"),
                     "--device", "cpu"]) == 0
        summary = _json_line(capsys)
        assert jax_main([*argv, "--signals-pkl",
                         str(tmp_path / "jax.pkl")]) == 0
        ref = _json_line(capsys)
        assert summary["traces"] == ref["traces"] == 30
        assert (summary["none"], summary["distinct_signals"]) == (
            ref["none"], ref["distinct_signals"])
        signals = _pickle_at(tmp_path / "port.pkl")
        assert signals == _pickle_at(tmp_path / "jax.pkl")
        assert sum(signals.values()) + summary["none"] == 30


def test_fluor_counts_cli_auto_calibrate_matches_the_jax_cli(tmp_path,
                                                             capsys):
    from fluorosequencingimageanalysis_torch.inference.photometries import (
        write_photometries_dict_to_csv)
    rng = np.random.default_rng(5)
    beta, n_cycles = 30000.0, 6
    photometries = {"ch1": {0: {}}}
    for t in range(160):
        n0 = int(rng.integers(1, 3))
        drop = int(rng.integers(1, n_cycles))
        counts = [n0] * drop + [n0 - 1] * (n_cycles - drop)
        photometries["ch1"][0][(t, t)] = (
            tuple(n > 0 for n in counts),
            tuple(float(n * beta * np.exp(rng.normal(0, 0.18))) if n else
                  float(rng.normal(0, 120.0)) for n in counts), t)
    tracks = str(tmp_path / "tracks.csv")
    write_photometries_dict_to_csv(photometries, tracks)
    for extra in ([], ["--beta", "29000", "--no-adjustment", "--truncate",
                       "1", "--ddif", "0.05"]):
        argv = ["fluor-counts", tracks, "--auto-calibrate", *extra]
        assert main([*argv, "--signals-pkl", str(tmp_path / "port.pkl"),
                     "--device", "cpu"]) == 0
        summary = _json_line(capsys)
        assert jax_main([*argv, "--signals-pkl",
                         str(tmp_path / "jax.pkl")]) == 0
        ref = _json_line(capsys)
        assert summary["traces"] == ref["traces"] == 160
        assert summary["calibration"] == ref["calibration"]
        assert 0.5 * beta < float(summary["calibration"]["beta"]) < 2 * beta
        signals = _pickle_at(tmp_path / "port.pkl")
        assert signals == _pickle_at(tmp_path / "jax.pkl")
        assert sum(signals.values()) > 100


def test_background_correct_cli_matches_the_jax_cli(tmp_path, capsys):
    keys = [((("A", i),), True, 1) for i in range(1, 7)]
    rng = np.random.default_rng(3)
    controls = []
    for i in range(3):
        controls.append(str(tmp_path / f"ac_{i}.pkl"))
        with open(controls[-1], "wb") as f:
            pickle.dump({k: 100 + int(rng.integers(-10, 10)) for k in keys},
                        f)
    boc = {k: 100 for k in keys}
    boc[((("A", 3),), True, 1)] = 1000
    boc[((("A", 2), ("A", 2)), True, 2)] = 40   # a multidrop signal
    boc[((("A", 1),), False, 2)] = 500          # not a zero: dropped
    boc_path = str(tmp_path / "boc.pkl")
    with open(boc_path, "wb") as f:
        pickle.dump(boc, f)
    for extra in ([], ["--omit-multidrop", "--sigma", "1.5", "--total", "6",
                       "--control-total", "6"]):
        argv = ["background-correct", boc_path, "--control-pkls", *controls,
                "--num-cycles", "6", "--background-pkl", "background.pkl",
                *extra]
        assert main([*argv, "--output-dir", str(tmp_path / "port")]) == 0
        summary = _json_line(capsys)
        assert jax_main([*argv, "--output-dir", str(tmp_path / "jax")]) == 0
        ref = _json_line(capsys)
        summary.pop("output"), ref.pop("output")
        assert summary == ref and summary["counts_out"] < summary["counts_in"]
        for name in ("corrected_signals.pkl", "background.pkl"):
            assert _pickle_at(tmp_path / "port" / name) == \
                _pickle_at(tmp_path / "jax" / name)
    assert not hasattr(build_parser().parse_args(argv), "device")


def test_remainder_correct_cli_matches_the_jax_cli(tmp_path, capsys):
    tracks = str(tmp_path / "tracks.csv")
    with open(tracks, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY",
                    "FRAME 0", "FRAME 1", "FRAME 2"])
        for t in range(6):
            w.writerow(["ch1", 0, t, 0, "(True, True, True)",
                        1000 + 3 * t, 1100 - t, 1000 + t * t])
        w.writerow(["ch1", 0, 99, 0, "(True, True, False)", 900, 950, 10])
        w.writerow(["ch1", 1, 5, 5, "(True, True, True)", 800, 850, 700])
    for method, extra in ((4, []), (1, ["--m1-diff-median"]), (1, []),
                          (2, ["--min", "3"]), (3, ["--min", "3"]),
                          (4, ["--min", "50"])):
        argv = ["remainder-correct", tracks, "--method", str(method), *extra]
        outs = {}
        for name, cli in (("port", main), ("jax", jax_main)):
            out = str(tmp_path / f"{name}_{method}.csv")
            assert cli([*argv, "--output", out, "--adjustments-pkl",
                        str(tmp_path / f"{name}.pkl")]) == 0
            outs[name] = _json_line(capsys)
            assert outs[name].pop("output") == out
            with open(out) as f:
                outs[name + "_text"] = f.read()
        assert outs["port"] == outs["jax"]
        assert outs["port_text"] == outs["jax_text"]
        assert _pickle_at(tmp_path / "port.pkl") == \
            _pickle_at(tmp_path / "jax.pkl")
        want_rows = 0 if "50" in extra else 7
        assert outs["port"]["rows"] == want_rows
        assert len(outs["port_text"].splitlines()) == 1 + want_rows
    assert main(["remainder-correct", tracks]) == 0  # default output path
    assert _json_line(capsys)["output"] == tracks + "_adjusted.csv"
    empty = str(tmp_path / "empty.csv")
    with open(empty, "w") as f:
        f.write("CHANNEL,FIELD,H,W,CATEGORY,FRAME 0\n")
    with pytest.raises(SystemExit, match="no traces"):
        main(["remainder-correct", empty])


@pytest.mark.parametrize("name", ["fluor-counts", "background-correct",
                                  "remainder-correct", "simulate"])
def test_inference_subcommands_have_the_jax_clis_flags(name):
    def flags(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                         a.choices and tuple(a.choices), a.required)
                for a in sub.choices[name]._actions}

    got, want = flags(build_parser()), flags(jax_build_parser())
    device = got.pop("device", None)
    assert got == want
    if name in ("fluor-counts", "simulate"):
        assert device == (("--device",), "cuda", None, None, None, False)
    else:
        assert device is None  # host code


def _jax_sim_draws(N, L, C, seed, device):
    """The uniforms of the JAX package's _simulate_batch (PRNGKey(seed))."""
    k_dud, k_tirf0, k_cycle = jax.random.split(jax.random.PRNGKey(seed), 3)
    per_cycle = [jax.random.split(k, 3) for k in jax.random.split(k_cycle,
                                                                  C)]

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return port_sim.SimDraws(
        t(jax.random.uniform(k_dud, (N, L))),
        t(jax.random.uniform(k_tirf0, (N, L))),
        t([jax.random.uniform(k[0], (N,)) for k in per_cycle]),
        t([jax.random.uniform(k[1], (N,)) for k in per_cycle]),
        t([jax.random.uniform(k[2], (N, L)) for k in per_cycle]))


def test_simulate_cli_equals_the_jax_clis_on_its_draws(tmp_path, capsys,
                                                       monkeypatch):
    """``simulate`` prints the JAX CLI's summary and pickles its results
    when both draw the same numbers (the port's generator is swapped for
    the JAX package's draws)."""
    monkeypatch.setattr(port_sim, "draw_simulation", _jax_sim_draws)
    monkeypatch.setattr(
        port_sim, "draw_normals",
        lambda shape, seed, device: torch.from_numpy(np.asarray(
            jax.random.normal(jax.random.PRNGKey(seed), shape,
                              jnp.float32))).to(device))
    argv = ["simulate", "ACKDYECAGKHSECAMKR", "CK", "--num-sims", "300",
            "--num-mocks", "3", "--dud-dyes", "0.5",
            "--surface-degradation-1", "0.3",
            "--surface-degradation-1-num-cycles", "4", "--ddif", "0.3"]
    assert main([*argv, "--results-pkl", str(tmp_path / "port.pkl"),
                 "--device", "cpu"]) == 0
    got = _json_line(capsys)
    assert jax_main([*argv, "--results-pkl", str(tmp_path / "jax.pkl")]) == 0
    want = _json_line(capsys)
    assert got.pop("results_pkl") != want.pop("results_pkl")
    assert got == want and got["distinct_patterns"] > 20
    port_res, jax_res = (_pickle_at(tmp_path / f"{n}.pkl")
                         for n in ("port", "jax"))
    assert len(port_res) == len(jax_res) == 300
    for g, w in zip(port_res, jax_res):
        assert g[:3] == w[:3]
        for label in w[3]:
            assert g[3][label][0] == w[3][label][0]
            np.testing.assert_allclose(g[3][label][1][0],
                                       w[3][label][1][0], rtol=2e-6)

