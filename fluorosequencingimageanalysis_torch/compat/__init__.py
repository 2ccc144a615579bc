"""The reference's module surface on the port.

Copies of the repo's root shims (``pflib``, ``flexlibrary``,
``phase_correlate``, ``stepfitting_library``, ``mpfit``, ``plotting``,
``cross_correlation``, ``mpfitexpr``, ``gaussfitter``, ``psf_fitter``,
``MCsimlib``, ``peptide_simulator``, ``jupyter_development``), of its
three imaging apps (``basic_image_script``, ``basic_experiment_script``,
``basic_timetrace_script``) and of its four inference apps
(``simulate_peptide``, ``lognormal_fitter_v2``,
``iterative_background_v2``, ``remainder_correction``), each importing
the PyTorch package instead of the JAX one. tests/test_torch_import.py
holds every copy equal to its original, import lines and the device
handling apart.

Nothing here takes a ``device`` argument, as the reference's modules take
none: the work runs on the process default device,
``_device.default_device()`` ("cuda" unless ``FSIA_TORCH_DEVICE`` or
``_device.set_default_device`` names another). Each app that reaches the
device has ``--device``, which sets it; the host-only apps
(``iterative_background_v2``, ``remainder_correction``) have none. Run an app as
``python -m fluorosequencingimageanalysis_torch.compat.<app> ...``.
"""
