"""The port stands alone: no jax, no JAX package, one set of config
defaults, and a kernel build that never falls back."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from fluorosequencingimageanalysis_tpu import config as jax_config

import fluorosequencingimageanalysis_torch as port
from fluorosequencingimageanalysis_torch import _build
from fluorosequencingimageanalysis_torch import config as port_config

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

PORT_DIR = os.path.dirname(os.path.abspath(port.__file__))
REPO = os.path.dirname(PORT_DIR)
MODULES = [
    "fluorosequencingimageanalysis_torch",
    "fluorosequencingimageanalysis_torch.__main__",
    "fluorosequencingimageanalysis_torch.api",
    "fluorosequencingimageanalysis_torch.batch",
    "fluorosequencingimageanalysis_torch.config",
    "fluorosequencingimageanalysis_torch._build",
    "fluorosequencingimageanalysis_torch.models.detect",
    "fluorosequencingimageanalysis_torch.parallel.mesh",
    "fluorosequencingimageanalysis_torch.ops.background",
    "fluorosequencingimageanalysis_torch.ops.consolidate",
    "fluorosequencingimageanalysis_torch.ops.fused_candidates",
    "fluorosequencingimageanalysis_torch.ops.fused_fit",
    "fluorosequencingimageanalysis_torch.ops.photometry",
    "fluorosequencingimageanalysis_torch.ops.registration",
    "fluorosequencingimageanalysis_torch.utils.checkpoint",
    "fluorosequencingimageanalysis_torch.utils.convert",
    "fluorosequencingimageanalysis_torch.utils.hashing",
    "fluorosequencingimageanalysis_torch.utils.imageio",
    "fluorosequencingimageanalysis_torch.utils.visualize",
    "fluorosequencingimageanalysis_torch.utils.synth",
    "fluorosequencingimageanalysis_torch.utils.profiling",
    "fluorosequencingimageanalysis_torch.utils.rounding",
    "fluorosequencingimageanalysis_torch.native.tracklink",
    "fluorosequencingimageanalysis_torch.native.stepchain",
    "fluorosequencingimageanalysis_torch.native.chisqfit",
    "fluorosequencingimageanalysis_torch.stepfitting",
    "fluorosequencingimageanalysis_torch.ops.special",
    "fluorosequencingimageanalysis_torch.ops.stepfit_batch",
    "fluorosequencingimageanalysis_torch.inference",
    "fluorosequencingimageanalysis_torch.inference.photometries",
    "fluorosequencingimageanalysis_torch.inference.lognormal",
    "fluorosequencingimageanalysis_torch.inference.calibration",
    "fluorosequencingimageanalysis_torch.inference.background",
    "fluorosequencingimageanalysis_torch.notebook",
    "fluorosequencingimageanalysis_torch.native.trackcsv",
    "fluorosequencingimageanalysis_torch.ops.lognormal",
    "fluorosequencingimageanalysis_torch.ops.fused_lognormal",
    "fluorosequencingimageanalysis_torch.pipeline.experiment",
    "fluorosequencingimageanalysis_torch.pipeline.fast_experiment",
    "fluorosequencingimageanalysis_torch.pipeline.fast_timetrace",
    "fluorosequencingimageanalysis_torch.pipeline.traces",
    "fluorosequencingimageanalysis_torch.pipeline.spots",
    "fluorosequencingimageanalysis_torch.pipeline.tracking",
    "fluorosequencingimageanalysis_torch.sim",
    "fluorosequencingimageanalysis_torch.sim.dye_sim",
    "fluorosequencingimageanalysis_torch.native.randsiggen",
    "fluorosequencingimageanalysis_torch.ops.mc_fit",
    "fluorosequencingimageanalysis_torch.ops.fused_mc_fit",
    "fluorosequencingimageanalysis_torch.tools.ab_mc_fit",
    "fluorosequencingimageanalysis_torch.ops.gmm_batch",
    "fluorosequencingimageanalysis_torch.ops.fused_gmm_em",
    "fluorosequencingimageanalysis_torch.tools.ab_gmm_em",
    "fluorosequencingimageanalysis_torch.ops.plateau_batch",
    "fluorosequencingimageanalysis_torch.ops.chisq_batch_device",
    "fluorosequencingimageanalysis_torch.inference.gmm",
    "fluorosequencingimageanalysis_torch.inference.lognormal_legacy",
    "fluorosequencingimageanalysis_torch.pipeline",
    "fluorosequencingimageanalysis_torch.mpfit_compat",
    "fluorosequencingimageanalysis_torch.plotting",
    "fluorosequencingimageanalysis_torch.compat",
    "fluorosequencingimageanalysis_torch.compat.pflib",
    "fluorosequencingimageanalysis_torch.compat.flexlibrary",
    "fluorosequencingimageanalysis_torch.compat.phase_correlate",
    "fluorosequencingimageanalysis_torch.compat.stepfitting_library",
    "fluorosequencingimageanalysis_torch.compat.mpfit",
    "fluorosequencingimageanalysis_torch.compat.plotting",
    "fluorosequencingimageanalysis_torch.compat.basic_image_script",
    "fluorosequencingimageanalysis_torch.compat.basic_experiment_script",
    "fluorosequencingimageanalysis_torch.compat.basic_timetrace_script",
    "fluorosequencingimageanalysis_torch.compat.cross_correlation",
    "fluorosequencingimageanalysis_torch.compat.mpfitexpr",
    "fluorosequencingimageanalysis_torch.compat.gaussfitter",
    "fluorosequencingimageanalysis_torch.compat.psf_fitter",
    "fluorosequencingimageanalysis_torch.compat.MCsimlib",
    "fluorosequencingimageanalysis_torch.compat.peptide_simulator",
    "fluorosequencingimageanalysis_torch.compat.jupyter_development",
    "fluorosequencingimageanalysis_torch.compat.simulate_peptide",
    "fluorosequencingimageanalysis_torch.compat.lognormal_fitter_v2",
    "fluorosequencingimageanalysis_torch.compat.iterative_background_v2",
    "fluorosequencingimageanalysis_torch.compat.remainder_correction",
    "fluorosequencingimageanalysis_torch.compat._on_default_device",
    "fluorosequencingimageanalysis_torch.parallel.multihost",
]
COMPAT_MODULES = ["pflib", "flexlibrary", "phase_correlate",
                  "stepfitting_library", "mpfit", "plotting",
                  "basic_image_script", "basic_experiment_script",
                  "basic_timetrace_script", "cross_correlation",
                  "mpfitexpr", "gaussfitter", "psf_fitter", "MCsimlib",
                  "peptide_simulator", "jupyter_development",
                  "simulate_peptide", "lognormal_fitter_v2",
                  "iterative_background_v2", "remainder_correction"]


def test_port_imports_and_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import numpy as np\n"
        "from fluorosequencingimageanalysis_torch.api import Pipeline\n"
        "from fluorosequencingimageanalysis_torch.config import (\n"
        "    DetectConfig, PipelineConfig)\n"
        "from fluorosequencingimageanalysis_torch.utils.synth import "
        "make_stack\n"
        "stack, _ = make_stack(1, 2, 48, 48, spots_per_field=3)\n"
        "cfg = PipelineConfig(detect=DetectConfig(max_candidates=16,\n"
        "                                         num_iters=3))\n"
        "out = Pipeline(cfg, device='cpu').run_stack(stack)\n"
        "assert out['keep'].shape == (1, 2, 16)\n"
        "from fluorosequencingimageanalysis_torch.utils.synth import (\n"
        "    make_experiment_stack)\n"
        "exp = make_experiment_stack(1, 3, 48, 48, spots_per_field=4)\n"
        "res = Pipeline(cfg, device='cpu').run_experiment(exp)\n"
        "assert res['rows'] and res['summary']['ch1']['trace_count']\n"
        "from fluorosequencingimageanalysis_torch.models.detect import (\n"
        "    find_peptides)\n"
        "from fluorosequencingimageanalysis_torch.utils.checkpoint import (\n"
        "    ArtifactStore)\n"
        "import tempfile\n"
        "frames = exp[0].astype(np.uint16)\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    pipe = Pipeline(cfg, device='cpu', store=ArtifactStore(tmp))\n"
        "    z = pipe.run_zstack(frames, box_size=16, filter_size=3)\n"
        "    assert z['keep'].shape == (3, 16) and z['keep'].any()\n"
        "    assert pipe.store.exists(next(pipe.store.keys()))\n"
        "assert find_peptides(frames[0], num_iters=3, device='cpu')\n"
        "from fluorosequencingimageanalysis_torch.utils.synth import (\n"
        "    make_movie, make_step_traces)\n"
        "pipe = Pipeline(device='cpu')\n"
        "movie = make_movie(T=10, H=64, W=64, n_spots=6)\n"
        "tt = pipe.run_timetrace(movie, max_candidates=64, mirror_start=4)\n"
        "assert tt['trace_count'] and tt['photometries'].shape[1] == 10\n"
        "traces = make_step_traces(6, 40)\n"
        "assert len(pipe.stepfit(traces)) == 6\n"
        "assert len(pipe.chi_squared_stepfit(traces, num_steps=4)) == 6\n"
        "from fluorosequencingimageanalysis_torch.utils.synth import (\n"
        "    make_v8_workload)\n"
        "ints, cats, _ = make_v8_workload(40, F=4, K=2)\n"
        "tracks = {'ch1': {0: {(i, i): (tuple(c), tuple(x), i) for i, (c, x)\n"
        "    in enumerate(zip(cats.tolist(), ints.tolist()))}}}\n"
        "fit = pipe.fluor_counts(tracks, 30000.0, 0.2)\n"
        "assert fit[1] == 40 and sum(fit[0].values()) + fit[2] == 40\n"
        "cal = pipe.fluor_counts_calibrated(tracks, max_possible=2)\n"
        "assert cal[1] == 40 and cal[4]['beta'] > 0\n"
        "from fluorosequencingimageanalysis_torch.sim.dye_sim import (\n"
        "    simulate_and_fit_batched)\n"
        "sim = simulate_and_fit_batched('ACKDYECAGK', {'K'}, 1, 4, 50,\n"
        "    30000.0, 0.2, ddif=[0.0] + [0.3] * 6, p=0.9, b=0.1, u=0.3,\n"
        "    device='cpu')\n"
        "assert sum(sim['signals'].values()) + sim['none_count'] == 50\n"
        "trie = pipe.simulate_signals({'P': (('AKCK', 'K'),)}, 0.9, 0.05,\n"
        "    0.1, {'K': (1, 2, 3), 'C': (2,)}, sample_size=20)\n"
        "assert list(trie.leaf_iterator())\n"
        "assert find_peptides(frames[0], fit_type='monte_carlo', N_iter=8,\n"
        "                     max_candidates=32, device='cpu')\n"
        "from fluorosequencingimageanalysis_torch.utils.synth import (\n"
        "    make_gmm_photometries)\n"
        "gmm = pipe.per_cycle_gmm(make_gmm_photometries(60, F=3),\n"
        "                         max_fluors=2, n_init=2, n_iter=5)\n"
        "assert sorted(gmm[0]) == [0, 1, 2]\n"
        "from fluorosequencingimageanalysis_torch.ops.plateau_batch import (\n"
        "    plateau_fit_batched)\n"
        "assert len(plateau_fit_batched(traces[:, :8], 2, scores='device',\n"
        "                               device='cpu')) == 6\n"
        "from fluorosequencingimageanalysis_torch.stepfitting import (\n"
        "    chi_squared_fit_batch)\n"
        "assert len(chi_squared_fit_batch(traces, num_steps=4,\n"
        "    engine='device', device='cpu')) == 6\n"
        "from fluorosequencingimageanalysis_torch import _device\n"
        "from fluorosequencingimageanalysis_torch.compat import (\n"
        "    flexlibrary, pflib)\n"
        "_device.set_default_device('cpu')\n"
        "img = flexlibrary.Image(image=frames[0])\n"
        "img.find_gaussian_psfs({'num_iters': 3})\n"
        "assert img.spots and img.spots[0].photometry() is not None\n"
        "ex = flexlibrary.SequenceExperiment([img, img],\n"
        "                                    alignment_frames=[img, img])\n"
        "assert ex.offsets_from_frames()[1] == (0.0, 0.0)\n"
        "assert pflib._psf_candidates(frames[0])\n"
        "import pickle\n"
        "from fluorosequencingimageanalysis_torch.__main__ import main\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    for i in range(3):\n"
        "        with open(f'{tmp}/s{i}.pkl', 'wb') as fh:\n"
        "            pickle.dump(fit[0], fh)\n"
        "    assert main(['background-correct', f'{tmp}/s0.pkl',\n"
        "                 '--control-pkls', f'{tmp}/s1.pkl', f'{tmp}/s2.pkl',\n"
        "                 '--num-cycles', '4', '--output-dir', tmp]) == 0\n"
        "bad = sorted(m for m in sys.modules if m.startswith(\n"
        "    ('jax', 'fluorosequencingimageanalysis_tpu'))\n"
        "    and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_the_jax_package():
    seen = []
    for root, dirs, files in os.walk(PORT_DIR):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs only
        for f in files:
            if f.endswith(".py"):
                seen.append(os.path.relpath(os.path.join(root, f), PORT_DIR))
                for name in _imported_names(os.path.join(root, f)):
                    assert not name.split(".")[0] in (
                        "jax", "jaxlib", "fluorosequencingimageanalysis_tpu"
                    ), (f, name)
    assert len(seen) >= 74
    # compat/ is walked too, and its modules import the port, never the
    # repo's root shims (which import the JAX package).
    assert {os.path.join("compat", m + ".py") for m in COMPAT_MODULES} <= \
        set(seen)
    for m in COMPAT_MODULES:
        path = os.path.join(PORT_DIR, "compat", m + ".py")
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not [a.name for a in node.names
                            if a.name in COMPAT_MODULES], (m, a.name)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module not in COMPAT_MODULES, (m, node.module)
    for name in _imported_names(os.path.join(REPO, "chip_smoke.py")):
        assert name.split(".")[0] not in (
            "jax", "fluorosequencingimageanalysis_tpu"), name


def test_config_is_the_jax_packages_config():
    """The port keeps its own copy of config.py (so it never imports the
    JAX package); it must define the same classes, fields and defaults."""
    names = ["DetectConfig", "RegistrationConfig", "PhotometryConfig",
             "StepfitConfig", "LognormalConfig", "PipelineConfig"]
    for n in names:
        a, b = getattr(port_config, n), getattr(jax_config, n)
        fa = [(f.name, str(f.type)) for f in dataclasses.fields(a)]
        fb = [(f.name, str(f.type)) for f in dataclasses.fields(b)]
        assert fa == fb, n
        if n != "PipelineConfig":
            assert dataclasses.asdict(a()) == dataclasses.asdict(b()), n
            assert a.__dataclass_params__.frozen
    assert port_config.PipelineConfig().asdict() == \
        jax_config.PipelineConfig().asdict()
    cli = "{'c_std': 3, 'r_2_threshold': 0.5}"
    assert dataclasses.asdict(port_config.DetectConfig.from_cli(cli)) == \
        dataclasses.asdict(jax_config.DetectConfig.from_cli(cli))
    with pytest.raises(ValueError, match="unknown"):
        port_config.DetectConfig.from_cli("{'nope': 1}")


def _code_without_imports_and_docstrings(path):
    """The AST of a module, without its import statements (the copies
    import their siblings from their own package, and Pillow where it is
    used) and without docstrings."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        if (body and isinstance(body[0], ast.Expr) and
                isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        node.body = [n for n in body
                     if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["checkpoint", "hashing", "imageio",
                                    "visualize"])
def test_copied_utils_are_the_jax_packages(module):
    """The port keeps its own copies of these numpy-only modules; they
    must stay the JAX package's code, statement for statement."""
    port_path = os.path.join(PORT_DIR, "utils", module + ".py")
    jax_path = os.path.join(REPO, "fluorosequencingimageanalysis_tpu",
                            "utils", module + ".py")
    assert _code_without_imports_and_docstrings(port_path) == \
        _code_without_imports_and_docstrings(jax_path)
    # Image libraries are imported where they are used, so the package
    # imports on a machine without them.
    tree = ast.parse(open(port_path).read())
    top = [a.name for n in tree.body if isinstance(n, ast.Import)
           for a in n.names] + [n.module for n in tree.body
                                if isinstance(n, ast.ImportFrom)
                                and n.level == 0]
    assert not [m for m in top if m and m.split(".")[0] in
                ("PIL", "imageio", "orbax")]


def test_copied_host_functions_are_the_jax_packages():
    """Functions copied out of modules that import jax: the same code,
    docstrings and comments apart."""
    def funcs(path, names):
        tree = ast.parse(open(path).read(), filename=path)
        out = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name in names:
                if isinstance(node.body[0], ast.Expr) and isinstance(
                        node.body[0].value, ast.Constant):
                    node.body = node.body[1:]
                out[node.name] = ast.dump(node)
        return out

    jax_dir = os.path.join(REPO, "fluorosequencingimageanalysis_tpu")
    for rel, names in [
            ("ops/consolidate.py", ["consolidate_host"]),
            ("ops/background.py", ["pairwise_zoom_bases",
                                   "reflect_window_index"]),
            ("pipeline/spots.py", [
                "sigma_clip_boxes", "sextractor_mode", "_mesh_background",
                "sextractor_aperture_sums", "_circle_pixel_area",
                "_aperture_fracs", "_aperture_sum"]),
            ("models/detect.py", ["unpack_spot_buckets", "_center_keys"]),
            ("ops/stepfit_batch.py", ["_plateaus_from_mask"]),
            ("pipeline/fast_timetrace.py", ["_initial_centers"])]:
        got = funcs(os.path.join(PORT_DIR, rel), names)
        want = funcs(os.path.join(jax_dir, rel), names)
        assert sorted(got) == sorted(names) == sorted(want), rel
        for n in names:
            assert got[n] == want[n], (rel, n)


def test_tf32_is_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_require_cuda_raises_without_a_card(monkeypatch):
    from fluorosequencingimageanalysis_torch import _device
    from fluorosequencingimageanalysis_torch.api import Pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _device.require_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline(device="cuda")
    assert _device.resolve_device("cpu") == torch.device("cpu")
    from fluorosequencingimageanalysis_torch.utils import profiling
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profiling.device_time(lambda: None)


def _fake_tree(tmp_path, monkeypatch, nvcc_body):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + nvcc_body)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    return csrc


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    _fake_tree(tmp_path, monkeypatch,
               'echo "error: no such intrinsic" >&2\nexit 2\n')
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build("k")
    left = os.listdir(tmp_path / "_build")
    assert left == []  # nothing half-written is left behind


def test_build_is_keyed_by_source_and_atomic(tmp_path, monkeypatch):
    log = tmp_path / "calls"
    csrc = _fake_tree(
        tmp_path, monkeypatch,
        f'echo call >> "{log}"\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n')
    so = _build.build("k")
    assert so == _build.library_path("k") and os.path.exists(so)
    assert so.endswith(".so") and _build.NVCC_FLAGS[1].endswith("sm_90a")
    assert "--use_fast_math" not in _build.flags("fit_quality")
    assert "-fmad=false" in _build.flags("fit_quality")
    assert _build.build("k") == so  # cached: no second compile
    assert log.read_text().count("call") == 1
    (csrc / "k.cu").write_text("// kernel, edited\n")
    assert _build.library_path("k") != so
    _build.build("k")
    assert log.read_text().count("call") == 2
    assert not [f for f in os.listdir(tmp_path / "_build")
                if f.endswith(".tmp")]


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    real_isfile = os.path.isfile
    monkeypatch.setattr(
        _build.os.path, "isfile",
        lambda p: False if p.endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_keeps_ptxas_report_and_hashes_headers(tmp_path, monkeypatch):
    csrc = _fake_tree(
        tmp_path, monkeypatch,
        'echo "ptxas info    : Used 96 registers, used 1 barriers" >&2\n'
        'echo "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill'
        ' loads" >&2\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n')
    flags = _build.flags("k")
    assert flags[flags.index("-Xptxas") + 1] == "-v"
    so = _build.build("k")
    assert _build.ptxas_path("k") == so[:-len(".so")] + ".ptxas.txt"
    assert _build.ptxas_info("k") == {"registers": 96, "spill_bytes": 12}
    (csrc / "shared.cuh").write_text("// header\n")
    assert _build.library_path("k") != so  # a header edit rebuilds
    (csrc / "k2.cu").write_text("// another kernel\n")
    built = _build.build_all(["k", "k2"])
    assert built == [_build.library_path("k"), _build.library_path("k2")]
    assert all(os.path.exists(p) for p in built)
    assert not [f for f in os.listdir(tmp_path / "_build")
                if f.endswith(".tmp")]


def test_ptxas_kernels_reports_each_instantiation(tmp_path, monkeypatch):
    _fake_tree(
        tmp_path, monkeypatch,
        'echo "ptxas info    : Compiling entry function \'_Z2k1ILi6EEv\' '
        'for \'sm_90a\'" >&2\n'
        'echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill'
        ' loads" >&2\n'
        'echo "ptxas info    : Used 64 registers, used 1 barriers" >&2\n'
        'echo "ptxas info    : Compiling entry function \'_Z3k_smv\' for '
        '\'sm_90a\'" >&2\n'
        'echo "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill'
        ' loads" >&2\n'
        'echo "ptxas info    : Used 90 registers, used 1 barriers" >&2\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n')
    _build.build("k")
    assert _build.ptxas_kernels("k") == {
        "_Z2k1ILi6EEv": {"registers": 64, "spill_bytes": 0},
        "_Z3k_smv": {"registers": 90, "spill_bytes": 12}}
    assert _build.ptxas_info("k") == {"registers": 90, "spill_bytes": 12}


def test_ptxas_info_raises_without_a_register_count(tmp_path, monkeypatch):
    _fake_tree(tmp_path, monkeypatch,
               'while [ "$1" != "-o" ]; do shift; done\n'
               'echo built > "$2"\n')
    _build.build("k")
    with pytest.raises(RuntimeError, match="no register count"):
        _build.ptxas_info("k")


def test_tracklink_source_is_the_jax_packages():
    """The port builds its own byte-for-byte copy of the native linker."""
    with open(os.path.join(PORT_DIR, "csrc", "tracklink.cpp"), "rb") as f:
        port_src = f.read()
    with open(os.path.join(REPO, "fluorosequencingimageanalysis_tpu",
                           "native", "tracklink.cpp"), "rb") as f:
        assert port_src == f.read()


def _fake_host_tree(tmp_path, monkeypatch, gxx_body):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    with open(os.path.join(PORT_DIR, "csrc", "tracklink.cpp")) as f:
        (csrc / "tracklink.cpp").write_text(f.read())
    gxx = tmp_path / "g++"
    gxx.write_text("#!/bin/sh\n" + gxx_body)
    gxx.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))


def test_failed_tracker_build_raises_without_fallback(tmp_path,
                                                      monkeypatch):
    from fluorosequencingimageanalysis_torch.native import tracklink
    _fake_host_tree(tmp_path, monkeypatch,
                    'echo "error: expected unqualified-id" >&2\nexit 1\n')
    assert _build.flags("tracklink") == _build.HOST_FLAGS
    assert "-ffp-contract=off" in _build.HOST_FLAGS
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build "
                       "tracklink.cpp(.|\\n)*expected unqualified-id"):
        tracklink.greedy_link([0.0], [0.0], [0, 1], (4, 4), 2)
    assert os.listdir(tmp_path / "_build") == []
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build("tracklink")


def test_tracker_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    log = tmp_path / "calls"
    _fake_host_tree(tmp_path, monkeypatch,
                    f'echo "$@" >> "{log}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    so = _build.build("tracklink")
    assert os.path.exists(so) and so == _build.library_path("tracklink")
    args = log.read_text().split()
    assert args[-1].endswith("tracklink.cpp")
    assert all(f in args for f in ("-O3", "-shared", "-fPIC"))
    assert _build.build("tracklink") == so  # cached: no second compile
    assert len(log.read_text().splitlines()) == 1
    assert not os.path.exists(_build.ptxas_path("tracklink"))
    (tmp_path / "csrc" / "extra.cuh").write_text("// a CUDA header\n")
    assert _build.library_path("tracklink") == so  # only .cu hash headers


def _definitions(path):
    """{name: AST dump} of a module's top-level functions and classes,
    docstrings apart."""
    tree = ast.parse(open(path).read(), filename=path)
    out = {}
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(getattr(body[0], "value", None),
                                   ast.Constant)
                    and isinstance(body[0].value.value, str)):
                sub.body = body[1:] or [ast.Pass()]
        out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel,differs", [
    ("stepfitting.py", ["chi_squared_fit_batch"]),
    ("pipeline/traces.py", [])])
def test_copied_step_fit_modules_are_the_jax_packages(rel, differs):
    """The float64 specification of the step fitters and the trace
    classes are copies: every function and class is the JAX package's
    statement for statement, ``chi_squared_fit_batch`` apart (no engine
    probe and no Python fallback in the port)."""
    got = _definitions(os.path.join(PORT_DIR, rel))
    want = _definitions(os.path.join(
        REPO, "fluorosequencingimageanalysis_tpu", rel))
    assert sorted(got) == sorted(want) and len(got) >= 4
    assert [n for n in got if got[n] != want[n]] == differs


@pytest.mark.parametrize("rel,differs", [
    ("inference/photometries.py", ["read_track_photometries_csv"]),
    ("inference/lognormal.py", ["photometries_lognormal_fit_v8",
                                "lognormal_fit_v8_from_csv"]),
    ("inference/calibration.py", []),
    ("inference/background.py", []),
    ("notebook.py", [])])
def test_copied_inference_modules_are_the_jax_packages(rel, differs):
    """The host half of fluor counting is copied: every function is the
    JAX package's statement for statement, apart from the CSV reader (a
    native parser that fails to build raises) and the two fitters whose
    ``mesh`` argument became ``device``."""
    got = _definitions(os.path.join(PORT_DIR, rel))
    want = _definitions(os.path.join(
        REPO, "fluorosequencingimageanalysis_tpu", rel))
    assert sorted(got) == sorted(want) and len(got) >= 6
    assert [n for n in got if got[n] != want[n]] == differs
    if rel == "inference/lognormal.py":
        with open(os.path.join(PORT_DIR, rel)) as f:
            text = f.read()
        for n in differs:  # and those two differ in nothing else
            assert got[n].replace("device", "mesh").replace(
                "Constant(value='cuda')", "Constant(value=None)") == want[n]
        assert "mesh" not in text.split('"""', 2)[2]


def test_scorer_host_functions_and_lazy_imports():
    """``sequence_table`` and ``seq_to_signal`` are the JAX package's code;
    scipy's and sklearn's optional pieces stay imported where used."""
    got = _definitions(os.path.join(PORT_DIR, "ops", "lognormal.py"))
    want = _definitions(os.path.join(
        REPO, "fluorosequencingimageanalysis_tpu", "ops", "lognormal.py"))
    for n in ("sequence_table", "seq_to_signal"):
        assert got[n] == want[n], n
    tree = ast.parse(open(os.path.join(PORT_DIR, "notebook.py")).read())
    top = [n.module for n in tree.body if isinstance(n, ast.ImportFrom)
           and n.level == 0]
    assert not [m for m in top if m and m.split(".")[0] in ("scipy",
                                                            "sklearn")]


def test_timetrace_experiment_methods_are_the_jax_packages():
    def methods(path):
        tree = ast.parse(open(path).read(), filename=path)
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "TimetraceExperiment")
        out = {}
        for node in cls.body:
            if isinstance(node, ast.FunctionDef):
                if isinstance(node.body[0], ast.Expr) and isinstance(
                        node.body[0].value, ast.Constant):
                    node.body = node.body[1:]
                out[node.name] = ast.dump(node)
        return out

    got = methods(os.path.join(PORT_DIR, "pipeline", "experiment.py"))
    want = methods(os.path.join(REPO, "fluorosequencingimageanalysis_tpu",
                                "pipeline", "experiment.py"))
    # The whole class now; only the batched step fit names its device.
    assert sorted(got) == sorted(want) and len(got) >= 9
    assert [n for n in got if got[n] != want[n]] == [
        "_stepfit_tracks_batched"]


def _without_comments(text):
    return [line.split("//")[0].rstrip() for line in text.splitlines()]


@pytest.mark.parametrize("name", ["stepchain", "chisqfit"])
def test_step_fit_cores_are_the_jax_packages(name):
    """The port builds its own copies of the two native step-fit cores:
    the same code line for line (a comment may name another place)."""
    with open(os.path.join(PORT_DIR, "csrc", name + ".cpp")) as f:
        port_src = f.read()
    with open(os.path.join(REPO, "fluorosequencingimageanalysis_tpu",
                           "native", name + ".cpp")) as f:
        jax_src = f.read()
    assert _without_comments(port_src) == _without_comments(jax_src)
    assert len(port_src.splitlines()) > 400
    if name == "stepchain":
        assert port_src == jax_src
    assert "-march=native" not in _build.flags(name)
    assert all(f in _build.flags(name)
               for f in ("-O3", "-ffp-contract=off", "-pthread"))


def test_failed_step_fit_core_builds_raise_without_fallback(tmp_path,
                                                            monkeypatch):
    import numpy as np

    from fluorosequencingimageanalysis_torch import stepfitting
    from fluorosequencingimageanalysis_torch.ops import stepfit_batch
    _fake_host_tree(tmp_path, monkeypatch,
                    'echo "error: expected unqualified-id" >&2\nexit 1\n')
    for name in ("stepchain", "chisqfit"):
        with open(os.path.join(PORT_DIR, "csrc", name + ".cpp")) as f:
            (tmp_path / "csrc" / (name + ".cpp")).write_text(f.read())
    traces = np.random.default_rng(0).normal(100, 5, (3, 30))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build "
                       "stepchain.cpp(.|\\n)*expected unqualified-id"):
        stepfit_batch.stepfit_batched(traces, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build "
                       "chisqfit.cpp(.|\\n)*expected unqualified-id"):
        stepfitting.chi_squared_fit_batch(traces, num_steps=3)
    assert os.listdir(tmp_path / "_build") == []


@pytest.mark.parametrize("rel", ["sim/proteome.py", "sim/trie.py",
                                 "sim/signals.py", "sim/polyfluor.py",
                                 "sim/events.py"])
def test_copied_simulation_modules_are_the_jax_packages(rel):
    """The host half of simulation is copied: every function and class is
    the JAX package's statement for statement."""
    got = _definitions(os.path.join(PORT_DIR, rel))
    want = _definitions(os.path.join(
        REPO, "fluorosequencingimageanalysis_tpu", rel))
    assert sorted(got) == sorted(want) and len(got) >= 3
    assert [n for n in got if got[n] != want[n]] == []


def test_simulation_package_and_its_host_functions_are_the_jax_packages():
    import fluorosequencingimageanalysis_tpu.sim as jax_sim
    import fluorosequencingimageanalysis_torch.sim as port_sim
    assert port_sim.__all__ == jax_sim.__all__
    assert all(hasattr(port_sim, n) for n in port_sim.__all__)
    jax_dir = os.path.join(REPO, "fluorosequencingimageanalysis_tpu")
    for rel, names in [("sim/dye_sim.py", ["decrements_from_loss_cycles"]),
                       ("models/detect.py", ["_mc_fit_image"])]:
        got = _definitions(os.path.join(PORT_DIR, rel))
        want = _definitions(os.path.join(jax_dir, rel))
        for n in names:
            assert got[n] == want[n], (rel, n)


def test_randsiggen_source_is_the_jax_packages():
    """The port builds its own copy of the native signal sampler: the same
    code line for line (one comment names the reference file without a
    machine path), with the host flags."""
    with open(os.path.join(PORT_DIR, "csrc", "randsiggen.cpp")) as f:
        port_src = f.read()
    with open(os.path.join(REPO, "fluorosequencingimageanalysis_tpu",
                           "native", "randsiggen.cpp")) as f:
        jax_src = f.read()
    assert _without_comments(port_src) == _without_comments(jax_src)
    assert len(port_src.splitlines()) == len(jax_src.splitlines()) > 200
    assert _build.flags("randsiggen") == _build.HOST_FLAGS



def _drop(node, kinds):
    """``node`` without the statements of ``kinds`` in any body."""
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if isinstance(body, list):
            sub.body = [n for n in body if not isinstance(n, kinds)]
    return node


def _unwrap_stages(node):
    """``node`` with every ``with profiling.stage(...):`` replaced by its
    body (the port's stage timers around copied code)."""
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if not isinstance(body, list):
            continue
        out = []
        for n in body:
            if isinstance(n, ast.With) and all(
                    isinstance(i.context_expr, ast.Call) and
                    ast.unparse(i.context_expr.func) == "profiling.stage"
                    for i in n.items):
                out.extend(n.body)
            else:
                out.append(n)
        sub.body = out
    return node


def _top_functions(path):
    tree = ast.parse(open(path).read(), filename=path)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            for sub in ast.walk(node):
                body = getattr(sub, "body", None)
                if (isinstance(body, list) and body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(getattr(body[0], "value", None),
                                       ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    sub.body = body[1:] or [ast.Pass()]
            out[node.name] = node
    return out, tree


def _as_mesh(node):
    """The JAX form of a port function whose ``device="cuda"`` argument was
    the JAX package's ``mesh=None``."""
    text = ast.dump(node).replace("device", "mesh")
    return text.replace("Constant(value='cuda')", "Constant(value=None)")


def test_mixture_modules_are_the_jax_packages():
    """The host halves of the mixtures slice are copies: the legacy fitters
    with no difference; inference/gmm.py but for the two functions that
    import scikit-learn where they use it and the two whose ``mesh`` became
    ``device`` (and gained stage timers); the plateau fitter's tables, host
    scorer and public functions (those gained ``device``); the EM's
    starts."""
    jax_dir = os.path.join(REPO, "fluorosequencingimageanalysis_tpu")
    got = _definitions(os.path.join(PORT_DIR, "inference",
                                    "lognormal_legacy.py"))
    want = _definitions(os.path.join(jax_dir, "inference",
                                     "lognormal_legacy.py"))
    assert sorted(got) == sorted(want) and len(got) >= 20
    assert [n for n in got if got[n] != want[n]] == []

    rel = os.path.join("inference", "gmm.py")
    got, tree = _top_functions(os.path.join(PORT_DIR, rel))
    want, _ = _top_functions(os.path.join(jax_dir, rel))
    assert sorted(got) == sorted(want) and len(got) >= 20
    differs = [n for n in got if ast.dump(got[n]) != ast.dump(want[n])]
    assert differs == ["_fit_gmm", "gmm_photometries_batched",
                       "per_cycle_gmm_batched", "_cluster_fit_2"]
    for n in ("_fit_gmm", "_cluster_fit_2"):
        imports = [ast.unparse(i) for i in ast.walk(got[n])
                   if isinstance(i, ast.ImportFrom)]
        assert all("sklearn" in i for i in imports) and imports
        assert ast.dump(_drop(got[n], (ast.ImportFrom,))) == \
            ast.dump(want[n])
    for n in ("gmm_photometries_batched", "per_cycle_gmm_batched"):
        assert _as_mesh(_unwrap_stages(got[n])) == ast.dump(want[n])
    top = [a.name for a in tree.body if isinstance(a, ast.Import)
           for a in a.names] + [a.module for a in tree.body
                                if isinstance(a, ast.ImportFrom)]
    assert not [m for m in top if m and m.split(".")[0] == "sklearn"]

    rel = os.path.join("ops", "plateau_batch.py")
    got, _ = _top_functions(os.path.join(PORT_DIR, rel))
    want, _ = _top_functions(os.path.join(jax_dir, rel))
    for n in ("_segmentations", "_combo_structure", "_scores_host"):
        assert ast.dump(got[n]) == ast.dump(want[n]), n
    for n in ("plateau_fit_batched", "all_plateau_fits_batched"):
        node = got[n]
        node.args.args = [a for a in node.args.args if a.arg != "device"]
        node.args.defaults = node.args.defaults[:-1]
        for call in ast.walk(node):
            if isinstance(call, ast.Call):
                call.keywords = [k for k in call.keywords
                                 if k.arg != "device"]
        assert ast.dump(node) == ast.dump(want[n]), n

    rel = os.path.join("ops", "gmm_batch.py")
    got, _ = _top_functions(os.path.join(PORT_DIR, rel))
    want, _ = _top_functions(os.path.join(jax_dir, rel))
    assert ast.dump(got["_init_params"]) == ast.dump(want["_init_params"])


def _class_methods(path, cls):
    """{name: AST dump} of the methods of class ``cls``, docstrings apart."""
    tree = ast.parse(open(path).read(), filename=path)
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                and n.name == cls)
    out = {}
    for m in node.body:
        if isinstance(m, ast.FunctionDef):
            _strip_docstrings(m)
            out[m.name] = m
    return out


def _strip_docstrings(node):
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            sub.body = body[1:] or [ast.Pass()]
    return node


def _without_keyword(node, arg):
    """``node`` with the keyword ``arg`` dropped from every call."""
    for call in ast.walk(node):
        if isinstance(call, ast.Call):
            call.keywords = [k for k in call.keywords if k.arg != arg]
    return node


def test_object_layer_is_the_jax_packages():
    """Spot, Image, the trackers and the experiment classes are host
    copies: every class, method and function is the JAX package's
    statement for statement, apart from the device calls (the batched
    photometry and its upload, registration, the batched step fit), the
    native tracker as the default, and one corrected error message."""
    jax_dir = os.path.join(REPO, "fluorosequencingimageanalysis_tpu")

    def both(rel):
        return (_definitions(os.path.join(PORT_DIR, rel)),
                _definitions(os.path.join(jax_dir, rel)))

    got, want = both("pipeline/spots.py")
    assert sorted(got) == sorted(want) and len(got) >= 10
    assert [n for n in got if got[n] != want[n]] == ["Image"]
    gm = _class_methods(os.path.join(PORT_DIR, "pipeline/spots.py"), "Image")
    wm = _class_methods(os.path.join(jax_dir, "pipeline/spots.py"), "Image")
    assert sorted(set(gm) - set(wm)) == ["__getstate__", "device_image"]
    assert not set(wm) - set(gm)
    # The cache measures only the spots it lacks; the batch runs on the
    # device copy of the image (uploaded once) and is timed as a stage.
    assert [n for n in wm if ast.dump(gm[n]) != ast.dump(wm[n])] == [
        "_spot_photometry", "photometry_cache_clear",
        "_compute_photometries"]
    clear = gm["photometry_cache_clear"]
    clear.body = clear.body[:-1]  # the device copies go too
    assert ast.dump(clear) == ast.dump(wm["photometry_cache_clear"])

    got, want = both("pipeline/tracking.py")
    assert sorted(got) == sorted(want) and len(got) >= 10
    assert [n for n in got if got[n] != want[n]] == [
        "accumulate_offsets", "greedy_particle_tracking"]
    assert got["accumulate_offsets"].replace("definition", "definiton") == \
        want["accumulate_offsets"]
    native = ast.parse("use_native = True").body[0]
    jax_default = ast.parse(
        "from ..native.tracklink import have_native\n"
        "use_native = have_native()").body
    assert got["greedy_particle_tracking"].replace(
        ast.dump(native), ", ".join(ast.dump(n) for n in jax_default)) == \
        want["greedy_particle_tracking"]

    got, want = both("pipeline/experiment.py")
    assert sorted(got) == sorted(want) and len(got) >= 8
    assert [n for n in got if got[n] != want[n]] == [
        "SequenceExperiment", "TimetraceExperiment"]
    rel = "pipeline/experiment.py"
    gm = _class_methods(os.path.join(PORT_DIR, rel), "SequenceExperiment")
    wm = _class_methods(os.path.join(jax_dir, rel), "SequenceExperiment")
    assert sorted(gm) == sorted(wm)
    assert [n for n in gm if ast.dump(gm[n]) != ast.dump(wm[n])] == [
        "offsets_from_frames"]
    gm = _class_methods(os.path.join(PORT_DIR, rel), "TimetraceExperiment")
    wm = _class_methods(os.path.join(jax_dir, rel), "TimetraceExperiment")
    n = "_stepfit_tracks_batched"
    assert ast.dump(_without_keyword(gm[n], "device")) == ast.dump(wm[n])

    import fluorosequencingimageanalysis_tpu.pipeline as jax_pipeline
    import fluorosequencingimageanalysis_torch.pipeline as port_pipeline
    assert port_pipeline.__all__ == jax_pipeline.__all__
    assert all(hasattr(port_pipeline, n) for n in port_pipeline.__all__)


@pytest.mark.parametrize("rel", ["mpfit_compat.py", "plotting.py"])
def test_mpfit_compat_and_plotting_are_the_jax_packages(rel):
    """Host copies: module code statement for statement, docstrings
    apart."""
    assert _code_without_imports_and_docstrings(
        os.path.join(PORT_DIR, rel)) == _code_without_imports_and_docstrings(
        os.path.join(REPO, "fluorosequencingimageanalysis_tpu", rel))
    assert len(_definitions(os.path.join(PORT_DIR, rel))) >= 3


def _module_without(path, names):
    """A module's AST without imports, docstrings and the top-level
    definitions ``names``."""
    tree = ast.parse(open(path).read(), filename=path)
    tree.body = [n for n in tree.body
                 if not (isinstance(n, (ast.FunctionDef, ast.ClassDef))
                         and n.name in names)]
    _strip_docstrings(tree)
    for sub in ast.walk(tree):
        body = getattr(sub, "body", None)
        if isinstance(body, list):
            sub.body = [n for n in body
                        if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return ast.dump(tree)


@pytest.mark.parametrize("name,differs", [
    ("pflib", ["_psf_candidates", "_fit_2d_gaussian"]),
    ("flexlibrary", []), ("phase_correlate", []),
    ("stepfitting_library", []), ("mpfit", []), ("plotting", []),
    ("basic_image_script", ["build_parser", "main"]),
    ("basic_experiment_script", ["build_parser", "main"]),
    ("basic_timetrace_script", ["build_parser", "main"]),
    ("cross_correlation", []), ("mpfitexpr", []),
    ("gaussfitter", ["gaussfit"]), ("psf_fitter", []), ("MCsimlib", []),
    ("peptide_simulator", []), ("jupyter_development", []),
    ("simulate_peptide", ["build_parser", "main"]),
    ("lognormal_fitter_v2", ["build_parser", "main"]),
    ("iterative_background_v2", []), ("remainder_correction", [])])
def test_compat_modules_are_the_root_shims(name, differs):
    """Each compat module is the repo's root module of that name with its
    imports pointed at the port: the same code apart from imports and
    docstrings, but for the two pflib functions and gaussfitter's
    ``gaussfit`` (its 5x5 path), which take their tensors to the device,
    and the device apps' ``--device`` (the parser gains it, ``main`` sets
    the default device from it). The parsers are held equal option by
    option."""
    port_path = os.path.join(PORT_DIR, "compat", name + ".py")
    root_path = os.path.join(REPO, name + ".py")
    assert _module_without(port_path, differs) == \
        _module_without(root_path, differs)
    if "main" not in differs:
        return
    trees = [ast.parse(open(p).read()) for p in (port_path, root_path)]
    mains = [next(n for n in t.body if isinstance(n, ast.FunctionDef)
                  and n.name == "main") for t in trees]
    set_dev = [s for s in mains[0].body if isinstance(s, ast.Expr)
               and ast.unparse(s) == "set_default_device(args.device)"]
    assert len(set_dev) == 1
    mains[0].body.remove(set_dev[0])
    assert _module_without_node(mains[0]) == _module_without_node(mains[1])

    import importlib
    port_mod = importlib.import_module(
        "fluorosequencingimageanalysis_torch.compat." + name)
    root_mod = importlib.import_module(name)

    def actions(parser):
        return [(a.option_strings, a.dest, a.default, a.nargs, a.type,
                 a.required, type(a).__name__) for a in parser._actions
                if a.dest not in ("device", "log_path")]
    assert actions(port_mod.build_parser()) == \
        actions(root_mod.build_parser())
    dev = [a for a in port_mod.build_parser()._actions if a.dest == "device"]
    assert len(dev) == 1 and dev[0].option_strings == ["--device"]


def _module_without_node(node):
    """A function's AST dump without docstrings and imports."""
    _strip_docstrings(node)
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if isinstance(body, list):
            sub.body = [n for n in body
                        if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return ast.dump(node)
