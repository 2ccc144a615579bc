"""Content-hash keyed artifact store (checkpoint / resume).

The reference checkpoints via file naming: PSF pkls keyed by image path +
timestamp hash, scripts globbing for existing ``*_psfs_*.pkl`` and fitting
only missing images (basic_experiment_script.py:16-23,241-257;
flexlibrary.py:540-546). This module is the framework-level generalization
(SURVEY.md section 5): artifacts are keyed by a SHA-256 of their inputs +
parameters, so any stage can ask "was this exact computation already done?"
regardless of file paths or wall clock.

Array trees are stored with orbax when available, falling back to
``np.savez``. Non-array metadata goes to JSON next to the arrays.

A copy of fluorosequencingimageanalysis_tpu/utils/checkpoint.py (so the port
never imports the JAX package); tests/test_torch_import.py holds the two
copies to the same code, and the keys ``content_key`` computes are the JAX
package's for the same parts.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np


def _framed(h, payload: bytes):
    """Length-framed update: without framing, adjacent variable-size
    parts can shift a boundary byte and collide — content_key('as', 'b')
    would equal content_key('a', 'sb')."""
    h.update(str(len(payload)).encode())
    h.update(b":")
    h.update(payload)


def _hash_part(h, part):
    if isinstance(part, bytes):
        h.update(b"b"); _framed(h, part)
    elif isinstance(part, str):
        h.update(b"s"); _framed(h, part.encode("utf-8"))
    elif isinstance(part, (int, float, bool)) or part is None:
        h.update(b"n"); _framed(h, repr(part).encode("utf-8"))
    elif isinstance(part, np.ndarray):
        h.update(b"a")
        _framed(h, str(part.dtype).encode())
        _framed(h, str(part.shape).encode())
        _framed(h, np.ascontiguousarray(part).tobytes())
    elif isinstance(part, dict):
        # Recurse so nested arrays hash by CONTENT: json.dumps'
        # default=str would summarize a large ndarray as its truncated
        # '[0 0 ... 0]' repr, colliding different inputs to one key.
        h.update(b"d")
        for k in sorted(part, key=repr):
            _hash_part(h, repr(k))
            _hash_part(h, part[k])
    elif isinstance(part, (list, tuple)):
        h.update(b"l")
        h.update(str(len(part)).encode())
        for item in part:
            _hash_part(h, item)
    elif hasattr(part, "__array__"):  # jax.Array and friends
        _hash_part(h, np.asarray(part))
    else:
        h.update(b"r"); _framed(h, repr(part).encode("utf-8"))


def content_key(*parts) -> str:
    """SHA-256 key from heterogeneous inputs: bytes, strings, numbers,
    dicts/lists/tuples (recursive, nested arrays by content), and
    numpy/jax arrays (raw bytes + dtype + shape)."""
    h = hashlib.sha256()
    for part in parts:
        _hash_part(h, part)
    return h.hexdigest()[:32]


class ArtifactStore:
    """Directory of content-addressed artifacts.

    >>> store = ArtifactStore("/tmp/artifacts")
    >>> key = content_key("detect", image_bytes, {"c_std": 2.0})
    >>> if not store.exists(key):
    ...     store.save(key, {"params": params}, meta={"stage": "detect"})
    >>> out = store.load(key)
    """

    def __init__(self, root: str, use_orbax: bool | None = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        if use_orbax is None:
            try:
                import orbax.checkpoint  # noqa: F401
                use_orbax = True
            except Exception:
                use_orbax = False
        self.use_orbax = use_orbax

    def _dir(self, key: str) -> str:
        return os.path.join(self.root, key)

    def exists(self, key: str) -> bool:
        return os.path.exists(os.path.join(self._dir(key), "_COMPLETE"))

    def save(self, key: str, tree: dict, meta: dict | None = None) -> str:
        """Atomically store a dict of arrays (+ JSON metadata)."""
        d = self._dir(key)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        arrays = {k: np.asarray(v) for k, v in tree.items()}
        if self.use_orbax:
            import orbax.checkpoint as ocp
            ckptr = ocp.PyTreeCheckpointer()
            ckptr.save(os.path.join(tmp, "tree"), arrays)
        else:
            np.savez(os.path.join(tmp, "tree.npz"), **arrays)
        if meta is not None:
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, sort_keys=True, default=str)
        with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
            f.write(key)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        return d

    def load(self, key: str) -> dict:
        d = self._dir(key)
        if not self.exists(key):
            raise KeyError(f"artifact {key} not found in {self.root}")
        tree_dir = os.path.join(d, "tree")
        if os.path.isdir(tree_dir):
            import orbax.checkpoint as ocp
            ckptr = ocp.PyTreeCheckpointer()
            return dict(ckptr.restore(tree_dir))
        with np.load(os.path.join(d, "tree.npz")) as z:
            return {k: z[k] for k in z.files}

    def meta(self, key: str) -> dict | None:
        p = os.path.join(self._dir(key), "meta.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def keys(self):
        for name in sorted(os.listdir(self.root)):
            if name.endswith(".tmp"):
                # Orphan of a crashed/interrupted save(): the tmp dir
                # already holds _COMPLETE (written before the atomic
                # rename), so exists() alone would report it as a key.
                continue
            if self.exists(name):
                yield name

    def get_or_compute(self, key: str, fn, meta: dict | None = None) -> dict:
        """Load if present, else compute fn() -> dict-of-arrays and save."""
        if self.exists(key):
            return self.load(key)
        tree = fn()
        self.save(key, tree, meta=meta)
        return tree
