"""Port parity: the compat modules (``fluorosequencingimageanalysis_torch.
compat``) vs the repo's root shims and apps, which run the JAX package.

Each compat module must export the names of its root shim, and the three
imaging apps, driven through ``main(argv)`` with ``--device cpu`` on the
planted images of tests/test_apps.py, must write the artifacts the root
apps write: psfs pickles and CSVs (keys and order equal; fitted floats at
the tolerances of tests/test_torch_detect.py, theta apart), track
photometry rows (keys, categories and order equal; values at rtol 1e-5,
atol 1e-2), category counts, offsets and statistics (equal), and the
timetrace CSV and step fits. The check of the reference's own module
surface needs a checkout of the reference, named by ``FSIA_REFERENCE_DIR``;
without one it skips.
"""

import ast
import csv
import glob
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_apps import _write_field_png
from test_torch_detect import _assert_psfs_parity

from fluorosequencingimageanalysis_torch import _device
from fluorosequencingimageanalysis_torch.compat import (
    basic_experiment_script as port_exp_app,
    basic_image_script as port_image_app,
    basic_timetrace_script as port_tt_app,
    flexlibrary as port_flexlibrary, pflib as port_pflib,
    phase_correlate as port_pc, plotting as port_plotting,
    stepfitting_library as port_sfl)

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

PHOT_RTOL, PHOT_ATOL = 1e-5, 1e-2
FLOAT_TOL = dict(rtol=5e-3, atol=5e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_default_device(monkeypatch):
    """The apps' --device sets a process-wide default: restore it."""
    monkeypatch.setattr(_device, "_DEFAULT", None)
    monkeypatch.setenv("FSIA_TORCH_DEVICE", "cpu")


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("__")
            and not isinstance(getattr(mod, n), type(os))}


@pytest.mark.parametrize("name", ["pflib", "flexlibrary", "phase_correlate",
                                  "stepfitting_library", "mpfit",
                                  "plotting"])
def test_compat_modules_export_the_root_shims_names(name):
    import importlib
    root = importlib.import_module(name)
    port = importlib.import_module(
        "fluorosequencingimageanalysis_torch.compat." + name)
    # Every name the root shim offers (its imports of numpy and the JAX
    # package's helpers included), bar modules; and the same __all__.
    missing = _public(root) - _public(port) - {"torch"}
    assert not missing, missing
    assert getattr(port, "__all__", None) == getattr(root, "__all__", None)
    for n in getattr(root, "__all__", []):
        assert callable(getattr(port, n)) or n.startswith("default"), n


def test_compat_pflib_matches_root(tmp_path):
    import pflib
    rng = np.random.default_rng(0)
    img = rng.normal(400, 8, (64, 64))
    hh, ww = np.indices((64, 64)).astype(float)
    img += 3000 * np.exp(-(((hh - 30.3) ** 2) + ((ww - 40.6) ** 2)) / 3.4)
    img += 2000 * np.exp(-(((hh - 12.6) ** 2) + ((ww - 20.2) ** 2)) / 3.4)
    img = np.round(img).astype(np.uint16)
    np.testing.assert_array_equal(port_pflib.default_correlation_matrix,
                                  pflib.default_correlation_matrix)
    h = port_pflib._epoch_to_hash(1500000000)
    assert h == pflib._epoch_to_hash(1500000000)
    assert port_pflib._hash_to_epoch(h) == 1500000000
    _assert_psfs_parity(port_pflib.find_peptides(img),
                        pflib.find_peptides(img), img)
    assert port_pflib._psf_candidates(img) == pflib._psf_candidates(img)
    assert port_pflib._psf_candidates(img, c_std=3) == \
        pflib._psf_candidates(img, c_std=3)
    with pytest.raises(ValueError, match="square"):
        port_pflib._psf_candidates(img, correlation_matrix=np.ones((4, 4)))
    assert port_pflib.illumina_s_n(img[28:33, 38:43]) == \
        pflib.illumina_s_n(img[28:33, 38:43])
    patch = img[28:33, 38:43].astype(np.float64)
    got, want = port_pflib._fit_2d_gaussian(patch), \
        pflib._fit_2d_gaussian(patch)
    np.testing.assert_allclose(got[:6], want[:6], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[7], want[7], rtol=1e-6)
    for seed in (0, 1):
        np.random.seed(seed)
        a = port_pflib._fit_2d_gaussian_monte_carlo(patch, N_iter=200)
        np.random.seed(seed)
        b = pflib._fit_2d_gaussian_monte_carlo(patch, N_iter=200)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    psfs = port_pflib.find_peptides(img)
    pkl = port_pflib.save_psfs_pkl(psfs,
                                   output_path=str(tmp_path / "x_psfs.pkl"))
    with open(pkl, "rb") as f:
        assert list(pickle.load(f)) == list(psfs)


def test_compat_registration_steps_flexlibrary_and_plotting(tmp_path):
    import phase_correlate
    import plotting
    import stepfitting_library
    rng = np.random.default_rng(1)
    img = rng.normal(100, 10, (64, 64))
    reg = np.roll(img, 3, axis=0)
    got = port_pc.phase_correlate(img, reg)
    assert got[:2] == phase_correlate.phase_correlate(img, reg)[:2] == \
        (-3.0, 0.0)
    lum = [10.0] * 10 + [0.0] * 10
    assert port_sfl.sliding_t_fitter(lum, window_radius=6,
                                     p_threshold=0.01) == \
        stepfitting_library.sliding_t_fitter(lum, window_radius=6,
                                             p_threshold=0.01)
    assert port_sfl._pairwise is not None
    assert hasattr(port_flexlibrary.Experiment, "greedy_particle_tracking")
    image = port_flexlibrary.Image(image=np.zeros((32, 32)))
    s = port_flexlibrary.Spot(image, 20, 8, 5)
    image.spots.append(s)
    assert list(image.get_photometry_aperture(s, radius=3).positions) == \
        [8, 20]
    signals = {((("A", 2),), True, 1): 10,
               ((("A", 1), ("A", 3)), True, 2): 5,
               ((("A", 0),), False, 1): 2}
    values = np.random.default_rng(0).normal(0, 1, 500)
    texts = []
    for mod in (port_plotting, plotting):
        kw = dict(num_mocks=1, num_edmans=3, num_mocks_omitted=0,
                  peptide_string="PEP", wavelength=561, zmin=None,
                  zmax=None, plot_remainders=True)
        for name in ("single_drops_heatmap_v2", "double_drops_heatmap_v2"):
            path = str(tmp_path / (name + ".html"))
            getattr(mod, name)(signals, filepath=path, **kw)
            texts.append(open(path).read())
        path = str(tmp_path / "hist.html")
        mod.plot_histogram(values, "T", "y", "x", True, path)
        texts.append(open(path).read())
    assert texts[:3] == texts[3:] and "svg" in texts[2]


# -- the apps ---------------------------------------------------------------

def _image_dirs(tmp_path):
    """The same planted tif in two directories (artifacts land beside the
    image, named by the run's epoch)."""
    from PIL import Image as PILImage
    rng = np.random.default_rng(21)
    arr = rng.normal(400, 8, (64, 64)).astype(np.float32)
    hh, ww = np.indices((64, 64)).astype(np.float32)
    for (h, w) in [(20.3, 20.6), (40.4, 45.2), (50.6, 12.3)]:
        arr += 3000.0 * np.exp(-(((hh - h) ** 2) + ((ww - w) ** 2)) /
                               (2 * 1.3 ** 2))
    dirs = []
    for name in ("root", "port"):
        d = tmp_path / name / "imgs"
        d.mkdir(parents=True)
        PILImage.fromarray(arr.astype(np.uint16)).save(str(d / "f0.tif"))
        dirs.append(d)
    return dirs


def _read_psfs_csv(path):
    with open(path) as f:
        return list(csv.reader(f, dialect="excel-tab"))


def test_basic_image_script_matches_root(tmp_path, monkeypatch):
    import basic_image_script
    root_dir, port_dir = _image_dirs(tmp_path)
    monkeypatch.chdir(tmp_path)
    args = ["--parameters", "{'c_std': 3}", "-L", str(tmp_path / "log")]
    processed = [basic_image_script.main(args + [str(root_dir)]),
                 port_image_app.main(args + ["--device", "cpu",
                                             str(port_dir)])]
    assert len(processed[0]) == len(processed[1]) == 1
    arts = []
    for d in (root_dir, port_dir):
        arts.append({ext: glob.glob(str(d) + f"/*_psfs_*.{ext}")
                     for ext in ("pkl", "csv", "png")})
        assert all(len(v) == 1 for v in arts[-1].values()), arts[-1]
    psfs = []
    for a in arts:
        with open(a["pkl"][0], "rb") as f:
            psfs.append(pickle.load(f))
    _assert_psfs_parity(psfs[1], psfs[0], None)
    rows = [_read_psfs_csv(a["csv"][0]) for a in arts]
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) == 4
    theta = rows[0][0].index("PSF (theta)")
    for a, b in zip(rows[1][1:], rows[0][1:]):
        assert os.path.basename(a[0]) == os.path.basename(b[0])
        keep = [i for i in range(1, len(a)) if i != theta]
        np.testing.assert_allclose([float(a[i]) for i in keep],
                                   [float(b[i]) for i in keep],
                                   **FLOAT_TOL)


def _experiment_files(tmp_path):
    rng = np.random.default_rng(1)
    anchors0 = [(12.3, 80.6), (80.3, 12.3), (84.6, 84.3), (15.3, 40.6),
                (55.6, 85.3), (85.3, 55.6)]
    anchors1 = [(12.6, 12.3), (80.3, 85.6), (84.3, 40.3), (40.6, 84.6),
                (14.3, 55.3), (60.6, 12.6)]
    spots0 = [(20.3, 20.6), (40.6, 45.3), (70.3, 30.3)]
    spots1 = [(25.3, 60.6), (50.6, 20.3)]
    presence0 = [(True, True, True), (True, True, False),
                 (True, False, False)]
    presence1 = [(True, True), (True, True), (True, False)]
    files = {"root": [], "port": []}
    for cycle in range(3):
        c0 = anchors0 + [s for s, p in zip(spots0, presence0[cycle]) if p]
        c1 = anchors1 + [s for s, p in zip(spots1, presence1[cycle]) if p]
        state = rng.bit_generator.state
        for name in files:
            rng.bit_generator.state = state  # the same noise in both trees
            d = tmp_path / name / f"cycle_{cycle:02d}"
            d.mkdir(parents=True)
            for f, coords in (("field_00.png", c0), ("field_01.png", c1)):
                _write_field_png(str(d / f), coords, rng=rng)
                files[name].append(str(d / f))
    return files


def _one(pattern):
    found = glob.glob(pattern)
    assert len(found) == 1, (pattern, found)
    return found[0]


@pytest.mark.parametrize("extra", [[], ["--sextractor", "--collate_fields"]])
def test_basic_experiment_script_matches_root(tmp_path, monkeypatch, extra):
    import basic_experiment_script
    files = _experiment_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    outs = {}
    for name, app in (("root", basic_experiment_script.main),
                      ("port", port_exp_app.main)):
        out = tmp_path / name / "out"
        out.mkdir()
        argv = ["--peptide_files", *files[name], "--output_directory",
                str(out), "--no_sanity_check_images", "-L",
                str(tmp_path / f"log_{name}")] + extra
        if name == "port":
            argv += ["--device", "cpu"]
        app(argv)
        outs[name] = out
    rows = []
    for name in ("root", "port"):
        with open(_one(str(outs[name] / "track_photometries_NO_NONES_*"))
                  ) as f:
            rows.append(list(csv.reader(f)))
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) > 10
    for i, (a, b) in enumerate(zip(rows[1][1:], rows[0][1:])):
        assert a[:5] == b[:5], (i, a[:5], b[:5])
        np.testing.assert_allclose([float(x) for x in a[5:]],
                                   [float(x) for x in b[5:]],
                                   rtol=PHOT_RTOL, atol=PHOT_ATOL)
    for prefix in ("category_counts_*.csv",):
        texts = [open(_one(str(outs[n] / prefix))).read()
                 for n in ("root", "port")]
        assert texts[0] == texts[1] and "[ON]" in texts[0]
    for prefix in ("offsets_dict_*.pkl", "category_stats_*.pkl",
                   "filtered_stats_*.pkl"):
        loaded = []
        for n in ("root", "port"):
            with open(_one(str(outs[n] / prefix)), "rb") as f:
                loaded.append(pickle.load(f))
        assert loaded[0] == loaded[1], prefix


def test_basic_timetrace_script_matches_root(tmp_path, monkeypatch):
    import basic_timetrace_script
    rng = np.random.default_rng(2)
    frames = {"root": [], "port": []}
    for f in range(12):
        coords = [(30, 30), (60, 70)] if f < 6 else [(60, 70)]
        state = rng.bit_generator.state
        for name in frames:
            rng.bit_generator.state = state
            d = tmp_path / name
            d.mkdir(exist_ok=True)
            path = d / f"frame_{f:03d}.png"
            _write_field_png(str(path), coords, rng=rng)
            frames[name].append(str(path))
    monkeypatch.chdir(tmp_path)
    res = {}
    for name, app in (("root", basic_timetrace_script.main),
                      ("port", port_tt_app.main)):
        out = tmp_path / name / "out"
        argv = ["--output_directory", str(out), "--no_sanity_check_images",
                "--save_traces_pkl", "-L", str(tmp_path / f"log_{name}")]
        if name == "port":
            argv += ["--device", "cpu"]
        app(argv + frames[name])
        with open(out / "test.csv") as f:
            rows = list(csv.reader(f))
        with open(out / "test.pkl", "rb") as f:
            fits = pickle.load(f)
        res[name] = (rows, fits)
        assert (out / "traces.pkl").exists()
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
                rtol=PHOT_RTOL, atol=PHOT_ATOL)
    assert fp.keys() == fr.keys() and ip.keys() == ir.keys()
    for k in fr:
        assert [p[:2] for p in fp[k].trace] == [p[:2] for p in fr[k].trace]


def test_compat_apps_default_to_the_card_and_raise_without_one(
        tmp_path, monkeypatch):
    monkeypatch.delenv("FSIA_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root_dir, _ = _image_dirs(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert port_image_app.build_parser().parse_args(
        [str(root_dir)]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_image_app.main(["-L", str(tmp_path / "log"), str(root_dir)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tt_app.main(["-L", str(tmp_path / "log"), "x.png"])
    assert not glob.glob(str(root_dir) + "/*_psfs_*")  # nothing written
    monkeypatch.setenv("FSIA_TORCH_DEVICE", "cpu")
    assert port_exp_app.build_parser().parse_args(
        ["--peptide_files", "a"]).device == "cpu"


def test_compat_app_runs_as_a_module_without_jax(tmp_path):
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['basic_image_script', '--device', 'cpu', '-L', "
            f"{str(tmp_path / 'log')!r}, {str(tmp_path)!r}]\n"
            "runpy.run_module('fluorosequencingimageanalysis_torch.compat."
            "basic_image_script', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.startswith(('jax', "
            "'fluorosequencingimageanalysis_tpu', 'pflib', 'flexlibrary'))"
            " and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


# -- the reference's own surface --------------------------------------------

REFERENCE = os.environ.get("FSIA_REFERENCE_DIR")


@pytest.mark.skipif(not REFERENCE or not os.path.isdir(REFERENCE or ""),
                    reason="needs a checkout of the reference "
                           "(FSIA_REFERENCE_DIR names its directory)")
@pytest.mark.parametrize("name,rel", [
    ("pflib", "pflib.py"), ("phase_correlate", "phase_correlate.py"),
    ("flexlibrary", "flexlibrary.py"),
    ("stepfitting_library", "stepfitting_library.py"),
    ("plotting", "plotting.py")])
def test_compat_modules_cover_the_references_surface(name, rel):
    import importlib
    port = importlib.import_module(
        "fluorosequencingimageanalysis_torch.compat." + name)
    tree = ast.parse(open(os.path.join(REFERENCE, rel), "rb").read())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert names
    assert not [n for n in names if not hasattr(port, n)]
