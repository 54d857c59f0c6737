"""Model weight resolution and the hdf5 -> native conversion cache.

Port of ``get_remote`` / ``load_patch_model`` of
``inaspeechsegmenter_tpu/models/registry.py`` (reference
remote_utils.py:4-27), over the port's own hdf5 reader:

- the search directories, in priority order: the explicit ``model_dir``,
  ``$ISS_TPU_MODEL_DIR``, ``~/.keras/inaSpeechSegmenter`` (the
  reference's Docker image bakes the weights there for its root user) and
  the user cache ``~/.cache/inaspeechsegmenter_tpu``; in each, a converted
  ``<stem>.npz`` and then the registered file itself;
- a released ``.hdf5`` is parsed once and its conversion cached as a
  native ``<stem>.npz`` (written to a per-process temp name, moved into
  place with ``os.replace``) recording the source's size and sha256, so
  a later run reuses it only for the same content;
- synthetic stand-ins need an opt-in (they live in ``model_dir`` or
  ``$ISS_TPU_MODEL_DIR``, or ``ISS_ALLOW_SYNTHETIC=1``) and never shadow
  a real file; a corrupt npz warns and is skipped;
- a registered name found nowhere is downloaded from its release URL
  (``DMODELS``, 60 s timeout), or raises ``ModelNotFoundError``.

The x-vector ResNet's weights are read from the model directory only:
the first of ``raw_81.npz`` (the JAX package's ``save_resnet_npz``
format), ``raw_81.pth`` and ``final.onnx``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import urllib.request
import warnings

import numpy as np

from .native import ImportedModel

ISS_URL = "https://github.com/ina-foss/inaSpeechSegmenter/releases/download/models/"
VFS_URL = "https://github.com/ina-foss/inaSpeechSegmenter/releases/download/interspeech23/"

DMODELS = {
    "keras_speech_music_cnn.hdf5": ISS_URL,
    "keras_speech_music_noise_cnn.hdf5": ISS_URL,
    "keras_male_female_cnn.hdf5": ISS_URL,
    "interspeech2023_all.hdf5": VFS_URL,
    "interspeech2023_cvfr.hdf5": VFS_URL,
    "final.onnx": VFS_URL,
    "raw_81.pth": VFS_URL,
}

XVECTOR_WEIGHTS = ("raw_81.npz", "raw_81.pth", "final.onnx")


class ModelNotFoundError(FileNotFoundError):
    pass


def _search_dirs(model_dir=None):
    dirs = [model_dir] if model_dir else []
    env = os.environ.get("ISS_TPU_MODEL_DIR")
    if env:
        dirs.append(env)
    dirs.append(os.path.expanduser("~/.keras/inaSpeechSegmenter"))
    dirs.append(os.path.expanduser("~/.cache/inaspeechsegmenter_tpu"))
    return dirs


def cache_dir(model_dir=None):
    """Where conversions and downloads go: ``model_dir``, else
    ``$ISS_TPU_MODEL_DIR``, else the user cache."""
    d = model_dir or os.environ.get("ISS_TPU_MODEL_DIR") or \
        os.path.expanduser("~/.cache/inaspeechsegmenter_tpu")
    os.makedirs(d, exist_ok=True)
    return d


_HASH_CACHE = {}


def _file_sha256(path):
    """Content hash, memoized on (path, size, mtime_ns) so repeated
    resolutions of the same weight file hash it once per process."""
    st = os.stat(path)
    key = (path, st.st_size, st.st_mtime_ns)
    h = _HASH_CACHE.get(key)
    if h is None:
        hh = hashlib.sha256()
        with open(path, "rb") as fh:
            for blk in iter(lambda: fh.read(1 << 20), b""):
                hh.update(blk)
        h = _HASH_CACHE[key] = hh.hexdigest()
    return h


def _npz_spec(path):
    """The embedded spec dict of a native checkpoint; ``{}`` for a valid
    npz without one (e.g. a ResNet checkpoint); ``None`` if the file is
    not a readable npz at all (corrupt / truncated — callers must not
    treat it as a checkpoint)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            if "__spec__" not in z.files:
                return {}
            return json.loads(bytes(z["__spec__"].tobytes()).decode())
    except Exception:
        return None


def _npz_matches_source(spec, source_path):
    """Does the conversion cache's recorded source identity match
    ``source_path``?  ``None`` when the npz predates source recording
    (callers fall back to the mtime heuristic).  Content-based: an mtime
    comparison alone misclassifies timestamp-preserving installs
    (cp -p / rsync -a) of updated weights."""
    src = spec.get("source")
    if not isinstance(src, dict):
        return None
    if src.get("size") != os.path.getsize(source_path):
        return False
    return src.get("sha256") == _file_sha256(source_path)


def _synthetic_allowed(path, model_dir=None):
    """Synthetic stand-ins require an explicit opt-in: the file lives
    under ``model_dir`` or ``$ISS_TPU_MODEL_DIR`` (the caller pointed the
    registry there on purpose), or ``ISS_ALLOW_SYNTHETIC=1``.  Without it
    a synthetic npz in a shared cache directory must never shadow real
    released weights (it would silently produce garbage segmentations)."""
    val = os.environ.get("ISS_ALLOW_SYNTHETIC", "").strip().lower()
    if val and val not in ("0", "false", "off", "no"):
        return True
    for d in (model_dir, os.environ.get("ISS_TPU_MODEL_DIR")):
        if d and os.path.abspath(path).startswith(os.path.abspath(d) + os.sep):
            return True
    return False


def get_remote(model_fname, allow_download=True, allow_synthetic=False,
               model_dir=None):
    """Resolve a model filename to a local path.

    Search order: per directory in priority order (``_search_dirs``), a
    native-converted ``.npz`` then the exact filename; then (optionally)
    download from the release URL into the cache dir.  A real weight file
    in a higher-priority directory therefore always beats a converted npz
    cached in a lower-priority one, and a same-directory npz older than
    its source file is ignored (stale conversion after a weight update).
    Synthetic stand-in checkpoints are skipped unless explicitly opted
    into (see ``_synthetic_allowed``); a skipped synthetic never shadows a
    real hdf5 found later in the search.
    """
    stem = os.path.splitext(model_fname)[0]

    def _usable_npz(p, source=None):
        if not os.access(p, os.R_OK):
            return False
        spec = _npz_spec(p)
        if spec is None:
            warnings.warn(
                f"ignoring unreadable native checkpoint {p} (corrupt or "
                "truncated npz); delete it to silence this warning",
                stacklevel=3)
            return False
        if spec.get("synthetic"):
            if source is not None:
                # real weights installed next to the stand-in always win
                return False
            return allow_synthetic or _synthetic_allowed(p, model_dir)
        if source is not None:
            match = _npz_matches_source(spec, source)
            if match is not None:
                return match       # content-verified conversion (or not)
            if os.path.getmtime(p) < os.path.getmtime(source):
                return False       # stale conversion of an updated source
        return True

    for d in _search_dirs(model_dir):
        npz = os.path.join(d, stem + ".npz")
        exact = os.path.join(d, model_fname)
        if _usable_npz(npz, exact if os.access(exact, os.R_OK) else None):
            return npz
        if os.access(exact, os.R_OK):
            # the conversion cache may live in a lower-priority dir (the
            # user cache): use it when it is REAL (a synthetic stand-in
            # must never shadow a real weight file) and provably derived
            # from this source — content identity when recorded, the
            # mtime heuristic for legacy caches without it
            for d2 in _search_dirs(model_dir):
                p2 = os.path.join(d2, stem + ".npz")
                if not os.access(p2, os.R_OK):
                    continue
                spec2 = _npz_spec(p2)
                if not isinstance(spec2, dict) or spec2.get("synthetic"):
                    continue
                match = _npz_matches_source(spec2, exact)
                if (match if match is not None else
                        os.path.getmtime(p2) >= os.path.getmtime(exact)):
                    return p2
            return exact
    if allow_download and model_fname in DMODELS:
        url = DMODELS[model_fname] + model_fname
        dest = os.path.join(cache_dir(model_dir), model_fname)
        try:
            # download to a per-process temp name: an interrupted transfer
            # must not leave a truncated file at the path every later run
            # resolves, and concurrent workers sharing the cache dir must
            # not truncate each other's in-flight downloads
            tmp = f"{dest}.part{os.getpid()}"
            try:
                # explicit timeout: a packet-dropping firewall must yield
                # the clear error below, not an indefinite hang
                with urllib.request.urlopen(url, timeout=60) as r, \
                        open(tmp, "wb") as fh:  # noqa: S310
                    shutil.copyfileobj(r, fh)
                os.replace(tmp, dest)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            return dest
        except Exception as exc:
            raise ModelNotFoundError(
                f"model {model_fname} not found locally and download from "
                f"{url} failed ({exc}). Place the file in one of "
                f"{_search_dirs(model_dir)} or set ISS_TPU_MODEL_DIR."
            ) from exc
    raise ModelNotFoundError(
        f"model {model_fname} not found in {_search_dirs(model_dir)}")


def load_patch_model(model_fname, model_dir=None, allow_download=True,
                     allow_synthetic=False):
    """Load a CNN/MLP by registry name (for instance
    ``keras_speech_music_noise_cnn.hdf5``) as a CPU ``ImportedModel``,
    converting hdf5 -> native on first use.  ``model.path`` is the file
    it was read from."""
    path = get_remote(model_fname, allow_download=allow_download,
                      allow_synthetic=allow_synthetic, model_dir=model_dir)
    if path.endswith(".npz"):
        model = ImportedModel.from_native(path)
        if model.spec.get("synthetic"):
            warnings.warn(
                f"loading SYNTHETIC random-weight stand-in {path} for "
                f"{model_fname}: outputs are not meaningful segmentations "
                "(install the released weights to get real results)",
                stacklevel=2)
        model.path = path
        return model
    model = ImportedModel.from_h5(path)
    model.path = path
    # record the source identity so cache reuse can verify CONTENT, not
    # just mtimes (timestamp-preserving weight installs otherwise resolve
    # to a stale conversion of the previous release)
    model.spec["source"] = {
        "name": os.path.basename(path),
        "size": os.path.getsize(path),
        "sha256": _file_sha256(path),
    }
    # cache the converted form for next time — atomically and with a
    # per-process temp name: a worker killed mid-write (or two converting
    # concurrently) must not leave a truncated npz that every later run
    # resolves first
    try:
        stem = os.path.splitext(os.path.basename(path))[0]
        dest = os.path.join(cache_dir(model_dir), stem + ".npz")
        tmp = f"{dest}.part{os.getpid()}.npz"
        try:
            model.save_native(tmp)
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    except OSError:
        pass
    return model


def _model_dir(what, model_dir):
    d = model_dir or os.environ.get("ISS_TPU_MODEL_DIR")
    if not d:
        raise ModelNotFoundError(
            f"no model directory for {what}: pass model_dir or set "
            "ISS_TPU_MODEL_DIR")
    return d


def resolve_xvector_weights(model_dir=None):
    """Path of the x-vector ResNet weights: the first of
    ``XVECTOR_WEIGHTS`` present in the model directory."""
    d = _model_dir("the x-vector weights", model_dir)
    for name in XVECTOR_WEIGHTS:
        path = os.path.join(d, name)
        if os.path.exists(path):
            return path
    raise ModelNotFoundError(
        f"no x-vector weights in {d} (looked for "
        f"{', '.join(XVECTOR_WEIGHTS)})")
