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


# Names of a root shim the port leaves out on purpose: the Python
# fallbacks of the native cores (the port's native cores have none).
DELIBERATE_GAPS = {"MCsimlib": {"have_native"}}


@pytest.mark.parametrize("name", ["pflib", "flexlibrary", "phase_correlate",
                                  "stepfitting_library", "mpfit",
                                  "plotting", "cross_correlation",
                                  "mpfitexpr", "gaussfitter", "psf_fitter",
                                  "MCsimlib", "peptide_simulator",
                                  "jupyter_development"])
def test_compat_modules_export_the_root_shims_names(name):
    import importlib
    root = importlib.import_module(name)
    port = importlib.import_module(
        "fluorosequencingimageanalysis_torch.compat." + name)
    # Every name the root shim offers (its imports of numpy and the JAX
    # package's helpers included), bar modules and the deliberate gaps;
    # and the same __all__.
    gaps = DELIBERATE_GAPS.get(name, set())
    missing = _public(root) - _public(port) - {"torch"} - gaps
    assert not missing, missing
    assert not gaps & _public(port)
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



# -- the remaining shims and the four inference apps -------------------------

def _as_root(monkeypatch, *names):
    """Point ``import <name>`` at the compat module of that name, so that a
    test written against a root shim or app runs the port's copy."""
    import importlib
    for name in names:
        monkeypatch.setitem(sys.modules, name, importlib.import_module(
            "fluorosequencingimageanalysis_torch.compat." + name))


@pytest.mark.parametrize("test,names", [
    ("test_gaussfitter_shim", ["gaussfitter"]),
    ("test_onedgaussfit_recovers", ["gaussfitter"]),
    ("test_multigaussfit_two_peaks", ["gaussfitter"]),
    ("test_collapse_gaussfit_cube", ["gaussfitter"]),
    ("test_mcsimlib_shim", ["MCsimlib"]),
    ("test_peptide_simulator_shim", ["peptide_simulator"]),
    ("test_jupyter_development_shim", ["jupyter_development"]),
    ("test_signal_correlation_metrics", ["jupyter_development"]),
    ("test_diff_signals_parity", ["jupyter_development"]),
    ("test_match_diagnostic_core", ["jupyter_development"]),
    ("test_mpfitexpr", ["mpfitexpr"]),
    ("test_psffit_airy", ["psf_fitter"]),
    ("test_cross_correlation_fit_lag", ["cross_correlation"])])
def test_compat_shims_pass_the_root_shims_checks(test, names, monkeypatch):
    """tests/test_compat.py's check of each shim, run on its compat copy."""
    import test_compat
    _as_root(monkeypatch, *names)
    getattr(test_compat, test)()


def test_compat_gaussfitter_and_v8_fit_equal_the_root_shims():
    """The 5x5 path of gaussfit (the port's batched LM on the default
    device) and the batched v8 fit of compat.MCsimlib give the root shims'
    answers on the same inputs."""
    import gaussfitter
    import MCsimlib
    from fluorosequencingimageanalysis_torch.compat import (
        MCsimlib as port_mcsim, gaussfitter as port_gf)
    from oracles import gauss2d_oracle
    rng = np.random.default_rng(3)
    for p_true in ([200.0, 3000.0, 2.4, 2.6, 1.2, 1.3, 0.0],
                   [150.0, 1800.0, 1.7, 2.9, 0.9, 1.4, 30.0]):
        data = gauss2d_oracle(p_true, (5, 5)) + rng.normal(0, 20, (5, 5))
        kw = dict(params=(np.median(data), np.amax(data), 2.5, 2.5, 1, 1, 0),
                  limitedmin=[True] * 7,
                  limitedmax=[False, False, True, True, True, True, True],
                  minpars=np.array([0.0, 100.0, 1.0, 1.0, 0.5, 0.5, 0.0]),
                  maxpars=np.array([0.0, 0.0, 4.0, 4.0, 3.0, 3.0, 360.0]))
        got, want = port_gf.gaussfit(data, **kw), gaussfitter.gaussfit(
            data, **kw)
        np.testing.assert_allclose(got[:6], want[:6], rtol=1e-6, atol=1e-6)
    phot = {"ch1": {0: {}}}
    for t in range(200):
        seq = (2, 1, 1, 0) if t % 3 else (1, 1, 0, 0)
        ints = tuple(float(rng.lognormal(np.log(30000.0 * v), 0.2)) if v
                     else float(abs(rng.normal(500, 100))) for v in seq)
        phot["ch1"][0][(t, 1)] = (tuple(v > 0 for v in seq), ints, t)
    kw = dict(beta=30000.0, beta_sigma=0.2, max_possible=4,
              quench_factors=(0.0,) + (0.3,) * 5)
    got = port_mcsim._photometries_lognormal_fit_MP_v8(phot, **kw)
    want = MCsimlib._photometries_lognormal_fit_MP_v8(phot, **kw)
    assert got[:3] == want[:3]


def _pin_clock(monkeypatch, *modules, epoch=1500000000.0):
    """time() of each module pinned: seeds and file names read it."""
    for mod in modules:
        monkeypatch.setattr(mod, "time", lambda: epoch)


@pytest.mark.parametrize("test,name", [
    ("test_simulate_peptide_and_lognormal_closure", "simulate_peptide"),
    ("test_remainder_correction_app", "remainder_correction"),
    ("test_iterative_background_app", "iterative_background_v2"),
    ("test_lognormal_fitter_v2_end_to_end", "lognormal_fitter_v2")])
def test_compat_inference_apps_pass_the_root_apps_checks(test, name,
                                                         tmp_path,
                                                         monkeypatch):
    """tests/test_apps.py's check of each app, run on its compat copy (on
    the CPU: the autouse fixture sets FSIA_TORCH_DEVICE)."""
    import test_apps
    _as_root(monkeypatch, name)
    getattr(test_apps, test)(tmp_path, monkeypatch)


def _seed_host_draws(monkeypatch):
    """The host simulator draws its seed from ``random``, reseeds it from
    entropy (seed None) and draws its intensities from ``np.random``: all
    pinned, so the root app and its copy simulate the same molecules."""
    import random
    seed = random.seed
    seed(11)  # the seed the simulator draws before it reseeds
    monkeypatch.setattr(random, "seed",
                        lambda a=None, **k: seed(7 if a is None else a))
    np.random.seed(5)


SIM_ARGS = ["AXXAXK", "A", "-m", "2", "-o", "1", "-e", "4",
            "--fluor_intensity", "30000", "--dye_destruction", "0.05"]


def test_compat_simulate_peptide_writes_the_root_apps_artifacts(
        tmp_path, monkeypatch):
    """The host simulation path on pinned draws: signals, error signals,
    the pickle's name and contents and the photometries CSV equal the
    root app's. The batched path draws from torch's generator, not
    jax.random: its signals are compared as distributions (total variation
    distance under 0.1 at 6,000 molecules)."""
    import pickle as pkl

    import simulate_peptide
    from fluorosequencingimageanalysis_torch.compat import (
        simulate_peptide as port_sim)
    _pin_clock(monkeypatch, simulate_peptide, port_sim)
    out = {}
    for label, mod in (("root", simulate_peptide), ("port", port_sim)):
        d = tmp_path / label
        _seed_host_draws(monkeypatch)
        res = mod.main(SIM_ARGS + ["-N", "400", "--batched_simulation", "off",
                                   "--output_directory", str(d)])
        files = sorted(os.listdir(d))
        with open(d / files[-1], "rb") as f:
            _, signals, mes = pkl.load(f)
        out[label] = (res, files, signals, mes,
                      open(d / files[0]).read())
    (r_res, r_files, r_sig, r_mes, r_csv) = out["root"]
    (p_res, p_files, p_sig, p_mes, p_csv) = out["port"]
    assert p_files == r_files and len(r_files) == 2
    assert p_res == r_res and p_sig == r_sig and p_mes == r_mes
    assert p_csv == r_csv
    assert sum(p_sig.values()) > 100

    dist = {}
    for label, mod in (("root", simulate_peptide), ("port", port_sim)):
        signals, _ = mod.main(SIM_ARGS + [
            "-N", "6000", "--batched_simulation", "on", "--no_csv",
            "--output_directory", str(tmp_path / ("b" + label))])
        total = sum(signals.values())
        assert total > 3000
        dist[label] = {k: v / total for k, v in signals.items()}
    keys = set(dist["root"]) | set(dist["port"])
    tvd = 0.5 * sum(abs(dist["root"].get(k, 0.0) - dist["port"].get(k, 0.0))
                    for k in keys)
    assert tvd < 0.1, tvd


def _v8_tracks(path, n=80, seed=22):
    import math
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(5)])
        for t in range(n):
            seq = (1, 1, 0, 0, 0) if t % 2 else (2, 1, 1, 0, 0)
            ints = [int(rng.lognormal(math.log(30000.0 * v), 0.2)) + 800
                    if v else int(abs(rng.normal(800, 100))) for v in seq]
            cat = tuple(v > 0 for v in seq)
            w.writerow(["ch1", 0, 10 + t, 20 + t,
                        "(" + ", ".join(str(c) for c in cat) + ")"] + ints)


def test_compat_lognormal_fitter_v2_writes_the_root_apps_artifacts(
        tmp_path, monkeypatch):
    """Same track CSV, pinned clock: the same file names, and the signals,
    intermediates (alpha, beta, the fits) and raw photometries equal."""
    import pickle as pkl

    import lognormal_fitter_v2
    from fluorosequencingimageanalysis_torch.compat import (
        lognormal_fitter_v2 as port_app)
    _pin_clock(monkeypatch, lognormal_fitter_v2, port_app)
    got = {}
    for label, mod in (("root", lognormal_fitter_v2), ("port", port_app)):
        d = tmp_path / label
        d.mkdir()
        path = str(d / "tracks.csv")
        _v8_tracks(path)
        monkeypatch.chdir(d)
        signals = mod.main([path, "-m", "1", "-o", "0", "-e", "4",
                            "--max_possible", "3"])
        files = sorted(os.listdir(d))
        loaded = {}
        for suffix in ("SIGNALS.pkl", "RAW_PHOTOMETRIES.pkl",
                       "INTERMEDIATES_v2.pkl"):
            name = next(n for n in files if n.endswith(suffix))
            with open(d / name, "rb") as f:
                loaded[suffix] = pkl.load(f)
        got[label] = (signals, files, loaded)
    (r_sig, r_files, r_l), (p_sig, p_files, p_l) = got["root"], got["port"]
    assert p_files == r_files
    assert p_sig == r_sig and sum(p_sig.values()) > 30
    assert p_l["SIGNALS.pkl"] == r_l["SIGNALS.pkl"]
    assert p_l["RAW_PHOTOMETRIES.pkl"] == r_l["RAW_PHOTOMETRIES.pkl"]
    (p_par, p_res, _), (r_par, r_res, _) = (p_l["INTERMEDIATES_v2.pkl"],
                                            r_l["INTERMEDIATES_v2.pkl"])
    assert p_par == r_par and p_res[:3] == r_res[:3]


def test_compat_host_apps_write_the_root_apps_files(tmp_path, monkeypatch):
    """remainder_correction and iterative_background_v2: every file the
    root app writes, byte for byte."""
    import iterative_background_v2
    import remainder_correction
    import test_apps
    from fluorosequencingimageanalysis_torch.compat import (
        iterative_background_v2 as port_ib, remainder_correction as port_rc)
    _pin_clock(monkeypatch, iterative_background_v2, port_ib)
    trees = {}
    for label, rc, ib in (("root", remainder_correction,
                           iterative_background_v2),
                          ("port", port_rc, port_ib)):
        d = tmp_path / label
        d.mkdir()
        monkeypatch.setitem(sys.modules, "remainder_correction", rc)
        monkeypatch.setitem(sys.modules, "iterative_background_v2", ib)
        test_apps.test_remainder_correction_app(d, monkeypatch)
        for method in ("1", "2", "3"):
            rc.main([str(d / "tracks.csv"), "--method", method,
                     "--save_adjustments"])
            os.rename(d / "tracks.csv_adjusted.csv",
                      d / f"adjusted_{method}.csv")
        test_apps.test_iterative_background_app(d, monkeypatch)
        trees[label] = {
            os.path.relpath(os.path.join(root, n), d):
                open(os.path.join(root, n), "rb").read()
            for root, _, names in os.walk(d) for n in names}
    assert sorted(trees["port"]) == sorted(trees["root"])
    assert len(trees["root"]) >= 10
    for name, data in trees["root"].items():
        if name.startswith("ac") or name == "boc.pkl":
            continue  # the inputs, written again in each directory
        assert trees["port"][name] == data, name


def test_compat_inference_app_runs_as_a_module_without_jax(tmp_path):
    path = str(tmp_path / "tracks.csv")
    _v8_tracks(path, n=40)
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['lognormal_fitter_v2', '--device', 'cpu', "
            f"{path!r}, '-m', '1', '-o', '0', '-e', '4']\n"
            "runpy.run_module('fluorosequencingimageanalysis_torch.compat."
            "lognormal_fitter_v2', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.startswith(('jax', "
            "'fluorosequencingimageanalysis_tpu', 'MCsimlib', 'pflib', "
            "'jupyter_development'))"
            " and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
