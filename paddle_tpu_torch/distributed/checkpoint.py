"""Durable, self-verifying checkpoints (port of
paddle_tpu/distributed/checkpoint.py, one process).

The on-disk format is the reference's, byte for byte, so a generation
written by either package verifies and restores in the other:

* a generation is a directory ``<dir>/<step>/`` holding ``manifest.json``
  (``FORMAT_VERSION``, the framework's version, the step, the JSON
  ``meta``, the tree's structure and, per leaf, its keypath, file, crc32,
  dtype name, shape and bytes), ``leaves/<i>.bin`` (each leaf's raw
  little-endian bytes, C order) and a ``COMMIT`` marker (the manifest's
  crc32);
* a save commits atomically: write into a hidden ``.tmp-`` directory,
  fsync every file and the directory, rename into place, write
  ``COMMIT``, fsync the parent.  A generation without its marker is a
  torn write; one whose bytes disagree with the manifest is corrupt.
  ``CheckpointManager.restore_latest`` moves either into ``quarantine/``
  (never deletes it) and cascades to the next-oldest generation; all of
  them bad is a clean ``(None, None)`` fresh start;
* the tree flattens in sorted-key order (dicts), in order (lists,
  tuples), every other node a leaf, to keypaths ``/a/b/0``.

Leaves are tensors copied to the host (``resilience.materialize``), numpy
arrays or numbers; a restore gives CPU torch tensors.  A bfloat16 leaf is
written as its raw 2-byte words under the dtype name ``"bfloat16"`` (as
ml_dtypes names it, which the reference reads) and read back through a
16-bit view: numpy has no bfloat16, and the port needs no ml_dtypes.

:class:`AsyncCheckpointer` writes on a background thread: the caller hands
it a host snapshot (the double buffer: the training step updates the
device state in place, so the copy is made on the training thread) and it
writes the newest of what it was given (a depth-1 queue, newest wins),
degrading then escalating on failure (``.fatal`` after ``max_failures``
consecutive failed generations).

Not ported (ROADMAP.md A9): the orbax fallback for pre-manifest
directories, ``shardings=`` placement onto a mesh, and the multi-process
gather and writer election; arguments that need them raise
``NotImplementedError``.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import uuid
import zlib
from typing import Any

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..utils.metrics import default_registry as _default_registry

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

_REG = _default_registry()
_m_saves = _REG.counter(
    "paddle_ckpt_saves_total",
    "durable checkpoint generation writes by result", label="result",
    preset=("ok", "failed"))
_m_save_ms = _REG.histogram(
    "paddle_ckpt_save_ms",
    "wall time of one durable generation write (fsyncs included; runs "
    "on the background writer under async saves)",
    [5, 10, 25, 50, 100, 250, 500, 1000, 5000, 30000, 120000])
_m_restore_ms = _REG.histogram(
    "paddle_ckpt_restore_ms",
    "wall time of restore_latest (verify + read + device placement)",
    [5, 10, 25, 50, 100, 250, 500, 1000, 5000, 30000, 120000])
_m_retries = _REG.counter(
    "paddle_ckpt_retries_total",
    "in-place save retries after a transient IO error")
_m_quarantines = _REG.counter(
    "paddle_ckpt_quarantines_total",
    "corrupt generations moved to quarantine/ by the restore cascade")
_m_cascade_depth = _REG.gauge(
    "paddle_ckpt_cascade_depth",
    "generations rejected before the most recent successful restore")
_m_superseded_rb = _REG.counter(
    "paddle_ckpt_superseded_rollbacks_total",
    "failed force-overwrites whose superseded generation was rolled "
    "back into its slot")
_m_async_dropped = _REG.counter(
    "paddle_ckpt_async_dropped_total",
    "generations superseded in the depth-1 async queue before being "
    "written (newest-wins)")
_m_async_stalls = _REG.counter(
    "paddle_ckpt_async_stalls_total",
    "flush/drain waits that timed out on a stalled writer")

__all__ = ["save_sharded", "restore_sharded", "verify_generation",
           "CheckpointManager", "AsyncCheckpointer", "CheckpointCorruption",
           "CheckpointTemplateMismatch", "FORMAT_VERSION"]

FORMAT_VERSION = "paddle_tpu.ckpt.v1"
MANIFEST_NAME = "manifest.json"
COMMIT_NAME = "COMMIT"
LEAVES_DIR = "leaves"
QUARANTINE_DIR = "quarantine"
_TMP_PREFIX = ".tmp-"
_A9 = ("is not ported yet (ROADMAP.md A9: multi-process checkpoints, "
       "mesh placement and the orbax fallback)")


class CheckpointCorruption(RuntimeError):
    """A generation failed verification (torn write, bit flip, missing
    leaf, manifest or marker, dtype or shape drift).  Raised only by an
    explicit single-generation restore; ``restore_latest`` quarantines and
    cascades instead."""

    def __init__(self, reason: str, path: str = ""):
        super().__init__(f"{reason} ({path})" if path else reason)
        self.reason = reason
        self.path = path


class CheckpointTemplateMismatch(ValueError):
    """The caller's restore template does not match the checkpoint (keys
    it never saved).  Not a CheckpointCorruption: the bytes are fine, so
    the cascade never quarantines a valid generation over it."""


def _framework_version() -> str:
    from .. import __version__
    return __version__


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse fsync on directories
    finally:
        os.close(fd)


def _host_array(v):
    """One leaf as (a C-contiguous host numpy array of its bytes, its dtype
    name): a bfloat16 tensor as its 16-bit words, named ``"bfloat16"``."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(v) if np.ndim(v) else np.asarray(v)
    return arr, arr.dtype.name


# -- tree <-> (structure json, flat leaves) ---------------------------------
def _flatten(tree):
    """Deterministic flatten: dicts in sorted-key order, lists and tuples
    in order, anything else a leaf.  Returns (structure, [(key, leaf)]):
    ``structure`` is a JSON mirror of the nesting (None when a dict has
    keys that are not all strings; restore then needs a template)."""
    leaves: list[tuple[str, Any]] = []
    plain = [True]
    structure = _flatten_node(tree, "", leaves, plain)
    return (structure if plain[0] else None), leaves


def _flatten_node(node, keypath, leaves, plain):
    # module-level, not a closure over ``leaves``: a recursive closure is
    # a reference cycle, which would keep a whole host snapshot alive
    # until the cyclic collector runs
    if isinstance(node, dict):
        if all(isinstance(k, str) for k in node):
            keys = sorted(node)
        else:
            plain[0] = False
            keys = sorted(node, key=lambda k: (k.__class__.__name__,
                                               repr(k)))
        return {"__kind__": "dict",
                "items": {k: _flatten_node(node[k], f"{keypath}/{k}",
                                           leaves, plain) for k in keys}}
    if isinstance(node, (list, tuple)):
        kind = "tuple" if isinstance(node, tuple) else "list"
        return {"__kind__": kind,
                "items": [_flatten_node(v, f"{keypath}/{i}", leaves, plain)
                          for i, v in enumerate(node)]}
    leaves.append((keypath or "/", node))
    return {"__kind__": "leaf", "i": len(leaves) - 1}


def _unflatten(structure, leaves):
    kind = structure["__kind__"]
    if kind == "dict":
        return {k: _unflatten(v, leaves)
                for k, v in structure["items"].items()}
    if kind in ("list", "tuple"):
        out = [_unflatten(v, leaves) for v in structure["items"]]
        return tuple(out) if kind == "tuple" else out
    return leaves[structure["i"]]


def _template_keys(template):
    """Keypaths of a template's leaves, in ``_flatten`` order."""
    return [k for k, _ in _flatten(template)[1]]


def _check_meta(meta):
    """The manifest is one json.dumps at the end of the write: refuse an
    unserialisable meta before any leaf is written."""
    try:
        json.dumps(meta)
    except (TypeError, ValueError) as e:
        bad = []
        for k, v in meta.items():
            try:
                json.dumps(v)
            except (TypeError, ValueError):
                bad.append(k)
        raise ValueError(
            f"checkpoint meta keys {bad} are not JSON-serializable ({e}) "
            "— manifest meta carries small JSON state only; arrays belong "
            "in the state tree") from None


# -- generation write / verify / read ---------------------------------------
def _write_generation(final_dir: str, state, meta=None, step=None):
    """The atomic commit protocol: tmp dir → fsync → rename → COMMIT
    marker → fsync.  Returns the manifest dict."""
    from ..utils import chaos

    if meta:
        _check_meta(meta)
    parent = os.path.dirname(final_dir) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, _TMP_PREFIX + os.path.basename(final_dir)
                       + "-" + uuid.uuid4().hex[:8])
    structure, leaves = _flatten(state)
    keys = [k for k, _ in leaves]
    if len(set(keys)) != len(keys):
        # a dict key holding '/' can collide with real nesting; restoring
        # such a manifest would hand both slots the same bytes
        dupes = sorted({k for k in keys if keys.count(k) > 1})
        raise ValueError(
            f"state tree flattens to colliding keypaths {dupes[:3]} "
            "(a dict key contains '/'?) — checkpoint manifests match "
            "leaves by keypath and cannot represent this tree")
    arrays = [(k, *_host_array(v)) for k, v in leaves]
    bad = [k for k, arr, _ in arrays if arr.dtype.hasobject]
    if bad:
        raise ValueError(
            f"state leaves {bad[:3]} have object dtype (a None or Python "
            "object in the tree?) — checkpoints store raw numeric buffers "
            "only")
    os.makedirs(os.path.join(tmp, LEAVES_DIR))
    entries = []
    for i, (key, arr, dtype) in enumerate(arrays):
        raw = arr.reshape(-1).view(np.uint8)     # the leaf's bytes, no copy
        fname = os.path.join(LEAVES_DIR, f"{i}.bin")
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        entries.append({
            "key": key,
            "file": fname,
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
            "dtype": dtype,
            "shape": list(arr.shape),
            "bytes": int(raw.nbytes),
        })
    manifest = {
        "format": FORMAT_VERSION,
        "framework_version": _framework_version(),
        "step": step,
        "saved_unix_time": time.time(),
        "meta": meta or {},
        "structure": structure,
        "leaves": entries,
    }
    man_bytes = json.dumps(manifest, indent=1, sort_keys=True).encode()
    with open(os.path.join(tmp, MANIFEST_NAME), "wb") as f:
        f.write(man_bytes)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(os.path.join(tmp, LEAVES_DIR))
    _fsync_dir(tmp)
    aside = None
    if os.path.exists(final_dir):
        if os.path.exists(os.path.join(final_dir, COMMIT_NAME)):
            # a forced overwrite of a committed generation: move it aside
            # and delete it only once the new COMMIT is durable, so a
            # crash in between leaves the old bytes recoverable
            qdir = os.path.join(parent, QUARANTINE_DIR)
            os.makedirs(qdir, exist_ok=True)
            aside = os.path.join(
                qdir, os.path.basename(final_dir) + ".superseded-"
                + uuid.uuid4().hex[:8])
            os.rename(final_dir, aside)
        else:
            _rmtree(final_dir)   # torn leftovers carry nothing durable
    try:
        os.rename(tmp, final_dir)
        _fsync_dir(parent)
        # torn-write injection point: visible but unmarked, what a
        # SIGKILL here would leave (ChaosTorn skips the OSError rollback)
        chaos.on_io("checkpoint.commit", path=final_dir)
        marker = {"committed_at": time.time(),
                  "manifest_crc32": zlib.crc32(man_bytes) & 0xFFFFFFFF}
        with open(os.path.join(final_dir, COMMIT_NAME), "w") as f:
            json.dump(marker, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(final_dir)
    except OSError:
        # a disk error mid-overwrite: roll the superseded generation back
        # into its slot, so a retry (or a crash before it) still finds it
        if aside is not None:
            if os.path.exists(final_dir) and not os.path.exists(
                    os.path.join(final_dir, COMMIT_NAME)):
                _rmtree(final_dir)
            if not os.path.exists(final_dir):
                try:
                    os.rename(aside, final_dir)
                    _m_superseded_rb.inc()
                except OSError:
                    pass  # its bytes stay in quarantine/ at least
        raise
    if aside is not None:
        _rmtree(aside)
    # bitflip injection point: the save looks successful, only the
    # manifest's crc can tell
    chaos.on_io("checkpoint.committed", path=final_dir)
    return manifest


def _rmtree(path: str):
    shutil.rmtree(path, ignore_errors=True)


def _is_pre_manifest(gen_dir: str) -> bool:
    """True when a directory predates the manifest format: no manifest, no
    COMMIT marker, no leaves/ (one with any of them but no manifest is a
    corrupted generation of this format)."""
    return (os.path.isdir(gen_dir)
            and not os.path.exists(os.path.join(gen_dir, MANIFEST_NAME))
            and not os.path.exists(os.path.join(gen_dir, COMMIT_NAME))
            and not os.path.isdir(os.path.join(gen_dir, LEAVES_DIR)))


def verify_generation(gen_dir: str, deep: bool = True):
    """Integrity check of one generation directory: (manifest, None) when
    valid, (None, reason) when not.  The structural pass (marker, manifest
    and its crc against the marker, format, each leaf's existence, size,
    dtype and shape) reads no payload; ``deep`` also reads and crc32s
    every leaf.  The restores pass ``deep=False`` and check each crc on
    the bytes they load (:func:`_read_leaf`): one pass over the disk."""
    commit_path = os.path.join(gen_dir, COMMIT_NAME)
    man_path = os.path.join(gen_dir, MANIFEST_NAME)
    if not os.path.isdir(gen_dir):
        return None, "missing-generation"
    if not os.path.exists(commit_path):
        return None, "torn-write: COMMIT marker absent"
    if not os.path.exists(man_path):
        return None, "missing-manifest"
    try:
        with open(man_path, "rb") as f:
            man_bytes = f.read()
        manifest = json.loads(man_bytes)
    except (OSError, ValueError) as e:
        return None, f"manifest-unreadable: {e}"
    try:
        with open(commit_path) as f:
            marker = json.load(f)
        want = marker.get("manifest_crc32")
        if want is not None and want != (zlib.crc32(man_bytes) & 0xFFFFFFFF):
            return None, "manifest-crc-mismatch vs COMMIT marker"
    except (OSError, ValueError):
        return None, "commit-marker-unreadable"
    if manifest.get("format") != FORMAT_VERSION:
        return None, f"unknown-format: {manifest.get('format')!r}"
    for e in manifest.get("leaves", []):
        fpath = os.path.join(gen_dir, e["file"])
        if not os.path.exists(fpath):
            return None, f"missing-leaf: {e['key']} ({e['file']})"
        size = os.path.getsize(fpath)
        if size != e["bytes"]:
            return None, (f"leaf-truncated: {e['key']} "
                          f"({size}/{e['bytes']} bytes)")
        try:
            itemsize = convert_dtype(e["dtype"]).itemsize
        except (TypeError, ValueError):
            return None, f"unknown-dtype: {e['key']} ({e['dtype']})"
        if int(np.prod(e["shape"], dtype=np.int64)) * itemsize != size:
            return None, f"shape-mismatch: {e['key']}"
        if deep:
            try:
                with open(fpath, "rb") as f:
                    raw = f.read()
            except OSError as exc:
                return None, f"leaf-unreadable: {e['key']} ({exc})"
            if (zlib.crc32(raw) & 0xFFFFFFFF) != e["crc32"]:
                return None, (f"crc-mismatch: {e['key']} "
                              "(bit-rot or torn write)")
    return manifest, None


def _read_leaf(gen_dir: str, entry) -> torch.Tensor:
    """One payload file as a CPU tensor, its length and crc32 checked on
    the very bytes loaded (the deep half of verification, fused into the
    load).  The tensor owns a fresh writable buffer."""
    with open(os.path.join(gen_dir, entry["file"]), "rb") as f:
        raw = bytearray(f.read())
    if len(raw) != entry["bytes"]:
        raise CheckpointCorruption(
            f"leaf-truncated: {entry['key']} "
            f"({len(raw)}/{entry['bytes']} bytes)", gen_dir)
    if (zlib.crc32(raw) & 0xFFFFFFFF) != entry["crc32"]:
        raise CheckpointCorruption(
            f"crc-mismatch: {entry['key']} (bit-rot or torn write)",
            gen_dir)
    dtype = convert_dtype(entry["dtype"])
    if not raw:
        return torch.empty(entry["shape"], dtype=dtype)
    return torch.frombuffer(raw, dtype=dtype).reshape(entry["shape"])


def _no_shardings(shardings):
    if shardings is not None:
        raise NotImplementedError(f"restore(shardings=) {_A9}")


def _load_generation(gen_dir: str, manifest, template=None):
    """A verified generation back as a tree of CPU tensors.  With a
    ``template`` leaves are matched by keypath (not position), and a
    missing key is an error, never a partial restore."""
    if template is None:
        structure = manifest.get("structure")
        if structure is None:
            raise CheckpointTemplateMismatch(
                f"checkpoint at {gen_dir} holds non-JSON container nodes; "
                "restore requires a template")
        return _unflatten(structure, [_read_leaf(gen_dir, e)
                                      for e in manifest["leaves"]])
    by_key = {e["key"]: e for e in manifest["leaves"]}
    keys = _template_keys(template)
    missing = [k for k in keys if k not in by_key]
    if missing:
        raise CheckpointTemplateMismatch(
            f"restore template keys absent from checkpoint: "
            f"{missing[:5]}{'…' if len(missing) > 5 else ''} "
            f"(checkpoint at {gen_dir} holds {len(by_key)} leaves; "
            "did the model/optimizer/scheduler change since the save?)")
    vals = {k: _read_leaf(gen_dir, by_key[k]) for k in keys}
    return _rebuild(template, "", vals)


def _rebuild(node, keypath, vals):
    """``template``'s structure with each leaf replaced by ``vals`` of its
    keypath (module-level for the reason ``_flatten_node`` is)."""
    if isinstance(node, dict):
        return {k: _rebuild(node[k], f"{keypath}/{k}", vals) for k in node}
    if isinstance(node, (list, tuple)):
        out = [_rebuild(v, f"{keypath}/{i}", vals)
               for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return (type(node)(*out) if hasattr(node, "_fields")
                    else tuple(out))
        return out
    return vals[keypath or "/"]


def _host_view(tree):
    """The tree's leaves on the host for a synchronous write, which
    consumes the bytes before it returns: CPU tensors are not copied."""
    from .resilience import materialize

    return materialize(tree, copy=False)


def _single_process():
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(f"a checkpoint of a process group {_A9}")


# -- single-checkpoint functional API ---------------------------------------
def save_sharded(state: Any, path: str, force: bool = True, meta=None):
    """Write ``state`` (a tree of tensors) durably to ``path`` with the
    atomic-commit and manifest protocol."""
    _single_process()
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint exists: {path} (force=False)")
    _write_generation(path, _host_view(state), meta=meta)
    return path


def restore_sharded(path: str, template: Any = None, shardings: Any = None):
    """Restore a checkpoint after verifying its manifest; ``template`` fixes
    the structure.  Raises CheckpointCorruption when the bytes disagree
    with the manifest."""
    _no_shardings(shardings)
    path = os.path.abspath(path)
    if _is_pre_manifest(path):
        raise NotImplementedError(
            f"restoring a pre-manifest (orbax) checkpoint at {path} {_A9}")
    manifest, reason = verify_generation(path, deep=False)
    if manifest is None:
        raise CheckpointCorruption(reason, path)
    return _load_generation(path, manifest, template)


# -- rolling manager ---------------------------------------------------------
class CheckpointManager:
    """Rolling step-indexed durable checkpoints and verified auto-resume.

    ``save(step, state)`` keeps the newest ``max_to_keep`` committed
    generations; ``restore_latest()`` verifies the newest generation and on
    any mismatch (torn write, bit flip, missing leaf, absent marker)
    quarantines it and cascades to the next-oldest valid one, returning
    (None, None) only when every generation is bad.  Thread-safe: a
    synchronous emergency save can land while an AsyncCheckpointer write
    is in flight."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        _single_process()
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)
        self._lock = threading.RLock()
        # the manifest of the last successful restore (its meta carries
        # the mesh and the lr schedule)
        self.last_restore_manifest = None

    # -- paths ---------------------------------------------------------
    def _gen_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _candidate_steps(self):
        """Every int-named generation dir, committed or not, newest first:
        the cascade must see torn generations to quarantine them."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted((int(n) for n in names if n.isdigit() and
                       os.path.isdir(os.path.join(self.directory, n))),
                      reverse=True)

    def all_steps(self):
        """Committed generations only, oldest first."""
        with self._lock:
            return sorted(
                s for s in self._candidate_steps()
                if os.path.exists(os.path.join(self._gen_dir(s),
                                               COMMIT_NAME)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------
    def save(self, step: int, state: Any, force: bool = False,
             meta=None, assume_host: bool = False,
             transient_retry: bool = True) -> bool:
        """Durable save of ``state`` at ``step``; False when the interval
        policy skips the step (or the step is already committed).  A
        transient IO error (EIO, an OSError with no errno) gets ONE retry
        in place; a persistent one (ENOSPC, EROFS, EACCES, ...) escalates
        at once.  ``transient_retry=False`` leaves every retry to the
        caller.  ``assume_host``: every leaf is already a host copy (the
        AsyncCheckpointer's path)."""
        from ..utils import chaos
        from .resilience import is_transient_io_error

        step = int(step)
        if not force:
            if self.save_interval_steps > 1 and \
                    step % self.save_interval_steps != 0:
                return False
            if os.path.exists(os.path.join(self._gen_dir(step),
                                           COMMIT_NAME)):
                return False  # already durably saved
        host_state = state if assume_host else _host_view(state)

        def _do():
            chaos.on_io("checkpoint.save")
            return _write_generation(self._gen_dir(step), host_state,
                                     meta=meta, step=step)

        t0 = time.monotonic()
        with self._lock:
            self._sweep_tmp()
            try:
                try:
                    _do()
                except OSError as e:
                    if not is_transient_io_error(e):
                        logger.error(
                            "checkpoint save step=%s hit persistent %s "
                            "(errno=%s): %s — NOT retrying, escalating",
                            step, type(e).__name__, e.errno, e)
                        raise
                    if not transient_retry:
                        raise
                    logger.warning("checkpoint save step=%s hit transient "
                                   "%s: %s — retrying once", step,
                                   type(e).__name__, e)
                    _m_retries.inc()
                    time.sleep(0.05)
                    _do()
            except BaseException:
                # chaos raises ChaosTorn, no OSError: a failed generation
                # is a failed generation either way
                _m_saves.inc("failed")
                raise
            _m_saves.inc("ok")
            _m_save_ms.observe((time.monotonic() - t0) * 1e3)
            self._prune()
        return True

    def _sweep_tmp(self):
        """Remove tmp dirs a crashed attempt left (never renamed, so
        invisible to restore)."""
        try:
            for n in os.listdir(self.directory):
                if n.startswith(_TMP_PREFIX):
                    _rmtree(os.path.join(self.directory, n))
        except OSError:
            pass

    def _prune(self):
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            logger.info("checkpoint: pruning generation %d "
                        "(max_to_keep=%d)", victim, self.max_to_keep)
            _rmtree(self._gen_dir(victim))
        # pre-manifest generations never earn a COMMIT marker, so
        # all_steps() never retires them: once committed generations fill
        # the retention window, reclaim the older ones.  Torn generations
        # stay for restore-time quarantine (they are evidence).
        if steps and len(steps) >= self.max_to_keep:
            for s in self._candidate_steps():
                if s < steps[0] and _is_pre_manifest(self._gen_dir(s)):
                    logger.info("checkpoint: pruning pre-manifest "
                                "generation %d", s)
                    _rmtree(self._gen_dir(s))

    # -- restore -------------------------------------------------------
    def manifest(self, step: int):
        """The verified manifest of one generation, or None."""
        return verify_generation(self._gen_dir(step))[0]

    def restore(self, step: int, template: Any = None,
                shardings: Any = None):
        """Verified restore of one explicit generation.  Raises
        CheckpointCorruption instead of cascading: an explicit step is a
        deliberate choice, and other bytes would be a worse answer."""
        _no_shardings(shardings)
        gen = self._gen_dir(step)
        manifest, reason = verify_generation(gen, deep=False)
        if manifest is None:
            if _is_pre_manifest(gen):
                raise NotImplementedError(
                    f"restoring pre-manifest generation {step} {_A9}")
            raise CheckpointCorruption(reason, gen)
        self.last_restore_manifest = manifest
        return _load_generation(gen, manifest, template)

    def restore_latest(self, template: Any = None, shardings: Any = None):
        """The newest valid generation as (step, state): the corruption
        cascade.  Every rejected generation is quarantined with its
        reason; (None, None) is a fresh start.  A template mismatch is the
        caller's and propagates (no generation is quarantined over it).
        A pre-manifest generation is left in place and passed over (its
        orbax restore is not ported)."""
        from ..utils import chaos
        _no_shardings(shardings)
        chaos.on_io("checkpoint.restore_latest")
        t0 = time.monotonic()
        rejected = 0
        with self._lock:
            for step in self._candidate_steps():
                gen = self._gen_dir(step)
                manifest, reason = verify_generation(gen, deep=False)
                if manifest is None:
                    if _is_pre_manifest(gen):
                        logger.error(
                            "pre-manifest generation %d cannot be restored "
                            "(the orbax fallback %s) — leaving it in place, "
                            "cascading past it", step, _A9)
                    else:
                        self._quarantine(step, reason)
                    rejected += 1
                    continue
                try:
                    state = _load_generation(gen, manifest, template)
                except CheckpointCorruption as e:
                    self._quarantine(step, e.reason)
                    rejected += 1
                    continue
                except OSError as e:
                    # an IO error reading the payload does not prove the
                    # bytes bad: leave the generation, cascade past it
                    logger.error(
                        "generation %d could not be read (%s: %s) — "
                        "leaving it in place, cascading past it",
                        step, type(e).__name__, e)
                    rejected += 1
                    continue
                self.last_restore_manifest = manifest
                _m_cascade_depth.set(rejected)
                _m_restore_ms.observe((time.monotonic() - t0) * 1e3)
                return step, state
        _m_cascade_depth.set(rejected)
        return None, None

    def _quarantine(self, step: int, reason: str):
        """Move a bad generation aside (never delete: the bytes are the
        post-mortem) and log what was rejected and why."""
        qdir = os.path.join(self.directory, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        slug = reason.split(":")[0].strip().replace(" ", "-")[:40]
        dest = os.path.join(qdir, f"{step}.{slug}")
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = os.path.join(qdir, f"{step}.{slug}.{n}")
        try:
            os.rename(self._gen_dir(step), dest)
        except OSError as e:
            logger.error("could not quarantine generation %d: %s", step, e)
            return
        _m_quarantines.inc()
        logger.warning(
            "checkpoint generation %d REJECTED (%s) — quarantined to %s, "
            "cascading to the next-oldest generation", step, reason, dest)

    def quarantined(self):
        """[(name, path)] of the quarantined generations."""
        qdir = os.path.join(self.directory, QUARANTINE_DIR)
        if not os.path.isdir(qdir):
            return []
        return sorted((n, os.path.join(qdir, n)) for n in os.listdir(qdir))

    # -- lifecycle -----------------------------------------------------
    def wait(self):
        """Saves are synchronous here (AsyncCheckpointer owns the
        background queue)."""

    def close(self):
        """Nothing is held between calls."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class AsyncCheckpointer:
    """Non-blocking durable saves over a CheckpointManager.

    ``submit(step, state)`` takes an already materialised host tree
    (``TrainEngine.ft_state``: the copy happens on the training thread,
    since the step updates the device state in place) and returns at
    once.  One writer thread drains a depth-1, newest-wins slot: when the
    disk is slower than the checkpoint interval, intermediate generations
    are dropped (``.dropped``) instead of queueing host copies.

    Failure policy, degrade then escalate: a failed generation logs a
    warning and training goes on without durability; after
    ``max_failures`` consecutive failed generations ``.fatal`` flips and
    ``on_fatal`` fires (``Model.fit`` then exits with
    ``resilience.DURABILITY_EXIT_CODE``).  A success resets the streak."""

    def __init__(self, mgr: CheckpointManager, max_failures: int = 3,
                 on_fatal=None, retries: int = 0, base_delay: float = 0.05):
        # retries 0: CheckpointManager.save already owns the errno-split
        # transient retry; a second layer would multiply the worst stall
        self.mgr = mgr
        self.max_failures = int(max_failures)
        self.on_fatal = on_fatal
        self.retries = retries
        self.base_delay = base_delay
        self.consecutive_failures = 0
        self.failed_generations = 0
        self.saved_generations = 0
        self.dropped = 0
        self.fatal = False
        self.last_error = None
        self._pending = None  # (step, state, force, meta): newest wins
        self._cv = threading.Condition()
        self._stop = False
        self._busy = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle-ckpt-writer")
        self._thread.start()

    def submit(self, step, state, force=False, meta=None) -> bool:
        """Queue a host-materialised state for its durable write; never
        blocks on the disk.  False when it replaced a pending generation
        (or the writer already escalated)."""
        if self.fatal:
            return False
        with self._cv:
            replaced = self._pending is not None
            if replaced:
                self.dropped += 1
                _m_async_dropped.inc()
                logger.info("async checkpoint: generation %s superseded "
                            "before write (newest-wins, depth-1 queue)",
                            self._pending[0])
            self._pending = (int(step), state, force, meta)
            self._cv.notify()
        return not replaced

    def _run(self):
        from .resilience import is_transient_io_error, retry_with_backoff

        while True:
            with self._cv:
                while self._pending is None and not self._stop:
                    self._cv.wait()
                if self._pending is None and self._stop:
                    return
                step, state, force, meta = self._pending
                self._pending = None
                self._busy = True
            try:
                retry_with_backoff(
                    lambda: self.mgr.save(step, state, force=force,
                                          meta=meta, assume_host=True),
                    retries=self.retries, base_delay=self.base_delay,
                    should_retry=is_transient_io_error,
                    label=f"async checkpoint save@{step}")
                self.consecutive_failures = 0
                self.saved_generations += 1
            except BaseException as e:  # noqa: BLE001 — the writer must
                # survive anything; the policy decides what is fatal
                self.last_error = e
                self.consecutive_failures += 1
                self.failed_generations += 1
                if self.consecutive_failures >= self.max_failures:
                    self.fatal = True
                    logger.error(
                        "async checkpoint: %d CONSECUTIVE generations "
                        "failed (last: %s: %s) — durability lost, "
                        "escalating", self.consecutive_failures,
                        type(e).__name__, e)
                    if self.on_fatal is not None:
                        try:
                            self.on_fatal(e)
                        except Exception:  # noqa: BLE001
                            pass
                else:
                    logger.warning(
                        "async checkpoint: generation %s failed (%s: %s) — "
                        "training continues WITHOUT durability (%d/%d "
                        "consecutive failures before escalation)", step,
                        type(e).__name__, e, self.consecutive_failures,
                        self.max_failures)
            finally:
                # drop the snapshot before going idle: it is a whole host
                # copy of the model and its optimizer
                state = None
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def flush(self, timeout: float = None):
        """Block until the queue is empty and the write in flight (if any)
        finished; True when drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending is not None or self._busy:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    _m_async_stalls.inc()
                    return False
                self._cv.wait(timeout=remaining)
        return True

    wait = flush

    def close(self, timeout: float = 30.0):
        drained = self.flush(timeout=timeout)
        if not drained:
            logger.error(
                "async checkpoint writer not drained after %.0fs — "
                "abandoning the in-flight generation; the newest durable "
                "generation on disk stands as the recovery point", timeout)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        # a writer that blew the budget is stuck in a syscall: a daemon
        # thread, not joined (the preemption path passes 0)
        self._thread.join(timeout=5.0 if drained else 0.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
