# Copied from paddle_tpu/fault/checkpoint.py (the port imports nothing of the
# JAX package) onto the port's framework/io.py, which writes the JAX
# package's format: a directory written by either package loads in the
# other. Only the load of host-state payloads differs (see load).
"""Durable, versioned training checkpoints.

Layout under the manager root::

    ckpt/
      step_00000042/
        model.pdparams        # framework.io pickles (atomic tmp+fsync+replace)
        optimizer.pdopt
        rng.pkl
        manifest.json         # {"step":42,"payloads":{name:{file,crc32,size}}}
      step_00000050/ ...
      latest                  # text: "step_00000050" — written LAST, atomically

Write ordering gives crash consistency without a journal: payloads land
first (each atomic + fsynced), then the manifest (atomic), then the
``latest`` pointer (atomic). A crash at any point leaves either the
previous checkpoint intact or a complete new one; a partially-written
directory is simply never pointed at and fails verification.

Read path: ``load()`` verifies the manifest's per-payload CRC32 before
unpickling; a corrupt/torn checkpoint (detected via checksum or decode
failure) triggers automatic fallback to the newest *verified-good* step,
counted in telemetry as ``fault.ckpt_recoveries``.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import warnings
import zlib

from ..framework.io import CheckpointCorruptError, atomic_write

__all__ = ["CheckpointManager", "CheckpointCorruptError", "STEP_PREFIX"]

STEP_PREFIX = "step_"
MANIFEST = "manifest.json"
LATEST = "latest"
#: payloads loaded as Tensors; the others keep numpy arrays
_TENSOR_PAYLOADS = ("model", "optimizer")


def _crc32_file(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            crc = zlib.crc32(b, crc)
    return crc & 0xFFFFFFFF


def _step_dirname(step):
    return f"{STEP_PREFIX}{int(step):08d}"


def _payload_filename(name):
    # keep the familiar paddle extensions where they apply
    if name == "model":
        return name + ".pdparams"
    if name == "optimizer":
        return name + ".pdopt"
    return name + ".pkl"


class CheckpointManager:
    """Versioned ``step_XXXXXXXX/`` checkpoints with manifest checksums,
    a last-written ``latest`` pointer, ``keep_last_n`` pruning and
    verified-fallback loading.

    Args:
        root: checkpoint directory (created on first save).
        keep_last_n: after each save, delete the oldest step dirs beyond
            this count (``None``/0 keeps everything). The step just saved
            is never pruned.
    """

    def __init__(self, root, keep_last_n=None):
        self.root = str(root)
        self.keep_last_n = int(keep_last_n) if keep_last_n else 0

    # -- introspection -------------------------------------------------------
    def steps(self):
        """Sorted step ids present on disk (complete or not)."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if name.startswith(STEP_PREFIX):
                try:
                    out.append(int(name[len(STEP_PREFIX):]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        """The step the ``latest`` pointer names, or None."""
        try:
            with open(os.path.join(self.root, LATEST)) as f:
                name = f.read().strip()
            if name.startswith(STEP_PREFIX):
                return int(name[len(STEP_PREFIX):])
        except (OSError, ValueError):
            pass
        return None

    def step_dir(self, step):
        return os.path.join(self.root, _step_dirname(step))

    def manifest(self, step):
        path = os.path.join(self.step_dir(step), MANIFEST)
        try:
            with open(path) as f:
                return json.load(f)
        except OSError as e:
            raise CheckpointCorruptError(path, "missing manifest") from e
        except ValueError as e:
            raise CheckpointCorruptError(path, f"bad manifest: {e}") from e

    # -- save ----------------------------------------------------------------
    def save(self, step, payloads):
        """Write checkpoint ``step`` from ``payloads`` (name -> picklable
        object, tensors handled by ``framework.io.save``). Returns the step
        directory. Ordering: payloads → manifest → ``latest`` pointer, each
        atomic, so a crash anywhere leaves a loadable history."""
        from ..framework.io import save as psave
        from ..profiler import telemetry
        from . import inject
        from .retry import retry

        t0 = time.perf_counter()
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        entries = {}
        for name, obj in payloads.items():
            fname = _payload_filename(name)
            fpath = os.path.join(d, fname)
            # transient filesystem errors (NFS hiccup) retry with backoff;
            # the write itself is atomic so a failed attempt leaves nothing
            retry(psave, obj, fpath, tries=3, base_delay=0.1,
                  retry_on=(OSError,))
            entries[name] = {
                "file": fname,
                "crc32": _crc32_file(fpath),
                "size": os.path.getsize(fpath),
            }
            if inject.check("ckpt.write") == "torn":
                # simulate a non-atomic writer dying mid-write: chop the
                # file AFTER its manifest entry recorded the intended
                # checksum, so only verification can catch the tear
                size = os.path.getsize(fpath)
                with open(fpath, "r+b") as f:
                    f.truncate(max(1, size // 2))
        manifest = {"step": int(step), "payloads": entries,
                    "saved_unix": time.time()}
        atomic_write(os.path.join(d, MANIFEST),
                     lambda f: f.write(json.dumps(manifest, indent=1).encode()))
        atomic_write(os.path.join(self.root, LATEST),
                     lambda f: f.write(_step_dirname(step).encode()))
        if self.keep_last_n:
            self.prune(keep_step=int(step))
        if telemetry.enabled():
            tm = telemetry.get_telemetry()
            tm.inc("fault.ckpt_saves")
            tm.observe("fault.ckpt_save_s", time.perf_counter() - t0)
        return d

    # -- verify / load -------------------------------------------------------
    def verify(self, step):
        """Check ``step``'s manifest and every payload checksum. Returns a
        list of problem strings — empty means verified-good."""
        problems = []
        d = self.step_dir(step)
        try:
            manifest = self.manifest(step)
        except CheckpointCorruptError as e:
            return [str(e)]
        for name, ent in manifest.get("payloads", {}).items():
            fpath = os.path.join(d, ent["file"])
            if not os.path.exists(fpath):
                problems.append(f"{name}: missing file {ent['file']}")
                continue
            size = os.path.getsize(fpath)
            if size != ent["size"]:
                problems.append(
                    f"{name}: size {size} != manifest {ent['size']}")
                continue
            crc = _crc32_file(fpath)
            if crc != ent["crc32"]:
                problems.append(
                    f"{name}: crc32 {crc:#010x} != manifest "
                    f"{ent['crc32']:#010x}")
        return problems

    def _load_verified(self, step):
        from ..framework.io import load as pload
        from .retry import retry

        problems = self.verify(step)
        if problems:
            raise CheckpointCorruptError(
                self.step_dir(step), "; ".join(problems))
        manifest = self.manifest(step)
        out = {}
        for name, ent in manifest["payloads"].items():
            # OSError retries (flaky reads); CheckpointCorruptError is a
            # RuntimeError and correctly propagates to the fallback scan.
            # The model and optimizer come back as Tensors on the current
            # place; the other payloads (RNG states, the cursor) are host
            # state and keep their numpy arrays
            out[name] = retry(
                pload, os.path.join(self.step_dir(step), ent["file"]),
                return_numpy=name not in _TENSOR_PAYLOADS,
                tries=3, base_delay=0.1, retry_on=(OSError,))
        return out

    def load(self, step=None):
        """Load checkpoint ``step`` (default: the ``latest`` pointer, else
        the newest step on disk), verifying checksums first. On corruption,
        fall back to the newest step that verifies, warning and counting a
        ``fault.ckpt_recoveries``. Returns ``(step, payloads)``, or ``None``
        when the root holds no checkpoints at all; raises
        :class:`CheckpointCorruptError` when checkpoints exist but none
        verifies."""
        from ..profiler import telemetry

        all_steps = self.steps()
        if not all_steps:
            return None
        candidates = []
        if step is not None:
            candidates = [int(step)]
        else:
            pointed = self.latest_step()
            if pointed is not None and pointed in all_steps:
                candidates.append(pointed)
            candidates += [s for s in sorted(all_steps, reverse=True)
                           if s not in candidates]
        last_err = None
        for i, s in enumerate(candidates):
            try:
                payloads = self._load_verified(s)
            except CheckpointCorruptError as e:
                last_err = e
                warnings.warn(f"checkpoint step {s} failed verification "
                              f"({e}); trying the previous one")
                continue
            if i > 0:
                if telemetry.enabled():
                    telemetry.get_telemetry().inc("fault.ckpt_recoveries")
                warnings.warn(
                    f"recovered from corrupt checkpoint: loaded verified "
                    f"step {s} instead of {candidates[0]}")
            return s, payloads
        raise CheckpointCorruptError(
            self.root, f"no verifiable checkpoint among steps {candidates}"
        ) from last_err

    # -- pruning -------------------------------------------------------------
    @classmethod
    def prune_flat(cls, save_dir, epochs, keep_last_n,
                   exts=(".pdparams", ".pdopt")):
        """Prune flat ``<epoch>.pdparams``/``.pdopt`` checkpoints (the hapi
        ``ModelCheckpoint`` layout): keep the newest ``keep_last_n`` of
        ``epochs`` (ascending), delete the rest. Returns pruned epochs."""
        keep = int(keep_last_n or 0)
        if keep <= 0 or len(epochs) <= keep:
            return []
        victims = list(epochs)[:-keep]
        for e in victims:
            for ext in exts:
                try:
                    os.remove(os.path.join(save_dir, str(e) + ext))
                except OSError:
                    pass
        return victims

    def prune(self, keep_last_n=None, keep_step=None):
        """Delete the oldest step dirs beyond ``keep_last_n`` (defaults to
        the manager's setting). ``keep_step`` (and whatever ``latest``
        points at) is never deleted. Returns the pruned step ids."""
        keep = self.keep_last_n if keep_last_n is None else int(keep_last_n)
        if not keep:
            return []
        steps = self.steps()
        protected = {keep_step, self.latest_step()}
        victims = [s for s in steps[:-keep] if s not in protected]
        for s in victims:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
        return victims
