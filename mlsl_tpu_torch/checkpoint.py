"""Checkpoint/resume: ``torch.save`` persistence of training state.

Counterpart of ``mlsl_tpu.checkpoint``. The JAX package writes through orbax;
the card's machine has none, so each step here is one ``torch.save`` file in
its own step directory, written into a temporary directory and renamed into
place when it is whole (orbax's commit). A JAX package's orbax checkpoint is
not loadable here, nor the reverse (ROADMAP, standing differences). The
rest is the reference's:

- **Async save.** ``save()`` returns before the write ends. It first copies
  the state to the host -- into pinned buffers reused across saves (a
  synchronous device-to-host copy on the card, a copy on the CPU) -- because
  the optimizers update their state in place (``optim.py``): a write that
  held the live tensors would write the next step's values. One write is in
  flight at a time; the next save, ``wait()`` and ``close()`` drain it.
- **Async errors surface.** A failed background write is raised by the next
  ``save()``/``wait()``/``close()``: a step whose write failed is never
  mistaken for a committed resume point.
- **Checksum manifests.** Every committed step gets ``manifest-<step>.json``
  of per-file sha256 sums, at the next drain point; ``verify()`` detects
  bit-rot. The chaos ``bitrot`` kind at ``checkpoint.save`` corrupts a step
  after its manifest is written.
- **Verified fallback.** ``restore_trainer`` walks steps newest VERIFIED
  first and skips a step that fails its checksum or whose restore raises.
- **Save retry.** An ``OSError`` at dispatch retries with exponential backoff
  (``MLSL_CKPT_SAVE_RETRIES`` / ``MLSL_CKPT_RETRY_BACKOFF_S``).
- **Verified-good steps.** A save made with a passing sentinel audit
  fingerprint records it, and the active world size, in the step's manifest.

State restores onto the template's device through ``map_location``: saved on
the card, it restores on the CPU, and the reverse. ``timings`` holds the last
save's dispatch and write, the last drain's sha256 and the last restore, in
ms, and the bytes of the last save.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional

import torch

from mlsl_tpu_torch import chaos
from mlsl_tpu_torch.config import _env_float, _env_int
from mlsl_tpu_torch.log import MLSLError, log_info, log_warning
from mlsl_tpu_torch.obs import tracer as obs
from mlsl_tpu_torch.sentinel import tree_leaves

STATE_FILE = "state.pt"
_TMP_SUFFIX = ".tmp-checkpoint"


def _host_tree(x, visit):
    """``x`` with every tensor replaced by ``visit(tensor)``; dicts stay
    dicts, sequences become lists (what ``torch.load(weights_only=True)``
    reads back)."""
    if isinstance(x, torch.Tensor):
        return visit(x)
    if isinstance(x, dict):
        return {k: _host_tree(v, visit) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host_tree(v, visit) for v in x]
    return x


class CheckpointManager:
    """Save and restore trees of tensors by step number."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        save_retries: Optional[int] = None,
        retry_backoff_s: Optional[float] = None,
    ):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.save_retries = (_env_int("MLSL_CKPT_SAVE_RETRIES", 3)
                             if save_retries is None else save_retries)
        self.retry_backoff_s = (_env_float("MLSL_CKPT_RETRY_BACKOFF_S", 0.05)
                                if retry_backoff_s is None else retry_backoff_s)
        self._unverified: set = set()  # steps saved but not yet checksummed
        self._bitrot: set = set()      # chaos: steps to corrupt post-manifest
        # step -> passing sentinel audit digest / active world size at save
        # time, recorded into the step's manifest at flush
        self._fingerprints: dict = {}
        self._worlds: dict = {}
        # the one write in flight, and the host buffers its snapshot lives in
        # (reused by the next save, which drains this write first)
        self._writer: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: Optional[concurrent.futures.Future] = None
        self._host: dict = {}
        # the writer's max_to_keep reaping against the drain's manifest pass
        self._fs_lock = threading.Lock()
        self.timings: dict = {}

    # -- async-error surfacing --------------------------------------------

    def _drain_write(self) -> None:
        """Wait for the write in flight, if any, and raise its error."""
        fut, self._pending = self._pending, None
        if fut is not None:
            fut.result()

    # -- save/restore ------------------------------------------------------

    def _snapshot(self, state: Any):
        """A host copy of ``state`` in this manager's reused buffers (pinned
        for a card's tensors). -> (copy, bytes). Returns once the copy is
        whole: the caller may update the live tensors right after."""
        leaves = []

        def visit(t: torch.Tensor) -> torch.Tensor:
            i = len(leaves)
            buf = self._host.get(i)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                self._host[i] = buf
            leaves.append((t, buf))
            return buf

        out = _host_tree(state, visit)
        on_card = False
        with torch.no_grad():
            for t, buf in leaves:
                buf.copy_(t.detach(), non_blocking=t.is_cuda)
                on_card = on_card or t.is_cuda
        if on_card:
            torch.cuda.synchronize()
        return out, sum(b.numel() * b.element_size() for _, b in leaves)

    def save(self, step: int, state: Any, wait: bool = False,
             fingerprint: Optional[str] = None,
             world: Optional[int] = None) -> None:
        """Dispatch an async save of ``state`` (a tree of tensors, ints and
        strings). ``fingerprint``: a PASSING sentinel audit digest of this
        state, recorded in the step's manifest (the step is then *verified*);
        ``world``: the active world size at save time. An ``OSError`` at
        dispatch retries with exponential backoff; anything else propagates."""
        self._drain_write()
        if fingerprint is not None:
            self._fingerprints[step] = fingerprint
        if world is not None:
            self._worlds[step] = int(world)
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        c0 = time.perf_counter()
        snap, nbytes = self._snapshot(state)
        tmp = os.path.join(self.directory, f"{step}{_TMP_SUFFIX}")
        delay = self.retry_backoff_s
        for attempt in range(self.save_retries + 1):
            try:
                # chaos first: an injected OSError takes the retry path a
                # flaky filesystem would
                plan = chaos.inject("checkpoint.save", step=step, attempt=attempt)
                if plan is not None and plan.kind == "bitrot":
                    self._bitrot.add(step)
                if os.path.isdir(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                break
            except OSError as e:
                if attempt >= self.save_retries:
                    raise
                if tr is not None:
                    tr.instant("ckpt.save.retry", "ckpt", step=step, attempt=attempt + 1,
                               error=repr(e))
                log_warning("checkpoint save of step %d failed (%s: %s); retry %d/%d in "
                            "%.2fs", step, type(e).__name__, e, attempt + 1,
                            self.save_retries, delay)
                time.sleep(delay)
                delay *= 2
        if self._writer is None:
            self._writer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mlsl-ckpt-write")
        self._pending = self._writer.submit(self._write, step, tmp, snap)
        self._unverified.add(step)
        self.timings.update(dispatch_ms=(time.perf_counter() - c0) * 1e3, bytes=nbytes)
        if tr is not None:
            # the dispatch only: the write runs in the background and its
            # drain lands in the wait() span
            tr.complete("ckpt.save", "ckpt", t0, step=step, attempts=attempt + 1)
        if wait:
            self.wait()

    def _write(self, step: int, tmp: str, snap) -> None:
        """The background half of a save: write, commit by rename, reap."""
        w0 = time.perf_counter()
        path = os.path.join(tmp, STATE_FILE)
        with open(path, "wb") as f:
            torch.save(snap, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.directory, str(step))
        with self._fs_lock:
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            if self.max_to_keep > 0:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        self.timings["write_ms"] = (time.perf_counter() - w0) * 1e3

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """Load the given (or latest) step; tensors land on the device of
        ``template``'s first tensor (the CPU without one)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        chaos.inject("checkpoint.restore", step=step)
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        r0 = time.perf_counter()
        dev = next((t.device for t in tree_leaves(template) if isinstance(t, torch.Tensor)),
                   torch.device("cpu"))
        d = self._step_dir(step)
        if d is None:
            raise MLSLError(f"checkpoint step {step} is not committed in {self.directory}")
        out = torch.load(os.path.join(d, STATE_FILE), map_location=dev, weights_only=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings["restore_ms"] = (time.perf_counter() - r0) * 1e3
        if tr is not None:
            tr.complete("ckpt.restore", "ckpt", t0, step=step)
        return out

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        tr = obs._tracer
        t0 = tr.now() if tr is not None else 0
        self._drain_write()
        self._flush_manifests()
        if tr is not None:
            tr.complete("ckpt.drain", "ckpt", t0)

    def close(self) -> None:
        try:
            self._drain_write()  # a failed final save must not vanish at close
            self._flush_manifests()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None

    # -- checksum manifests ------------------------------------------------

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest-{step}.json")

    def _step_dir(self, step: int) -> Optional[str]:
        """The committed step directory, or None while the save is in flight
        (the temporary directory is renamed into place only on commit)."""
        cand = os.path.join(self.directory, str(step))
        return cand if os.path.isdir(cand) else None

    @staticmethod
    def _file_sha256(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()

    def _checksum_tree(self, root: str) -> dict:
        files = {}
        for base, _, names in os.walk(root):
            for n in sorted(names):
                p = os.path.join(base, n)
                files[os.path.relpath(p, root)] = self._file_sha256(p)
        return files

    def _flush_manifests(self) -> None:
        """Write ``manifest-<step>.json`` for every save committed since the
        last flush, then apply any chaos bit-rot (after the manifest, as real
        rot happens: the manifest holds the good bytes, so verify() catches
        the corruption)."""
        with self._fs_lock:
            s0 = time.perf_counter()
            live = set(self.all_steps())
            newest = max(live) if live else None
            for step in sorted(self._unverified):
                d = self._step_dir(step)
                if d is None:
                    if newest is not None and step < newest:
                        # an OLDER step gone from disk was reaped by max_to_keep
                        self._unverified.discard(step)
                    continue  # else still in flight
                manifest = {"step": step, "written_at": time.time(),
                            "files": self._checksum_tree(d)}
                w = self._worlds.pop(step, None)
                if w is not None:
                    manifest["world"] = w
                fp = self._fingerprints.pop(step, None)
                if fp is not None:
                    # verified-good: the state passed the sentinel's audit at
                    # save time and this digest names those bytes
                    manifest["sentinel"] = {"fingerprint": fp}
                tmp = self._manifest_path(step) + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(manifest, f)
                os.replace(tmp, self._manifest_path(step))
                self._unverified.discard(step)
                if step in self._bitrot:
                    self._bitrot.discard(step)
                    self._apply_bitrot(step, d)
            self.timings["sha256_ms"] = (time.perf_counter() - s0) * 1e3
            # drop manifests whose step was reaped
            for name in os.listdir(self.directory):
                if name.startswith("manifest-") and name.endswith(".json"):
                    try:
                        s = int(name[len("manifest-"):-len(".json")])
                    except ValueError:
                        continue
                    if s not in live and s not in self._unverified:
                        try:
                            os.remove(os.path.join(self.directory, name))
                        except OSError:
                            pass

    def _apply_bitrot(self, step: int, step_dir: str) -> None:
        """Chaos 'bitrot' kind: flip bytes in the largest payload file of a
        committed step, as on-disk corruption after a clean write would;
        verify() must fail for this step afterwards."""
        target, size = None, -1
        for base, _, names in os.walk(step_dir):
            for n in names:
                p = os.path.join(base, n)
                sz = os.path.getsize(p)
                if sz > size:
                    target, size = p, sz
        if target is None:
            return
        with open(target, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(64) or b"\0"
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        log_warning("chaos: bit-rot injected into step %d (%s)", step, target)

    def _manifest(self, step: int) -> Optional[dict]:
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def recorded_fingerprint(self, step: int) -> Optional[str]:
        """The sentinel audit digest this step's manifest records, or None
        (no manifest yet, or a step saved without one: unverified)."""
        fp = self._fingerprints.get(step)
        if fp is not None:
            return fp  # save dispatched, manifest not yet flushed
        manifest = self._manifest(step)
        return ((manifest or {}).get("sentinel") or {}).get("fingerprint")

    def recorded_world(self, step: int) -> Optional[int]:
        """The active world size this step's manifest records, or None."""
        w = self._worlds.get(step)
        if w is not None:
            return w
        w = (self._manifest(step) or {}).get("world")
        return int(w) if w is not None else None

    def verify(self, step: int) -> Optional[bool]:
        """True: manifest present and every file matches. False: corrupt
        (mismatch, missing file or unreadable manifest). None: no manifest."""
        mp = self._manifest_path(step)
        if not os.path.exists(mp):
            return None
        manifest = self._manifest(step)
        if manifest is None:
            return False
        d = self._step_dir(step)
        if d is None:
            return False
        for rel, want in manifest.get("files", {}).items():
            try:
                if self._file_sha256(os.path.join(d, rel)) != want:
                    return False
            except OSError:
                return False
        return True


def _trainer_state(trainer, step: int) -> dict:
    """A DataParallelTrainer's resume state (``checkpoint.py:373-392`` of the
    JAX package): the parameters by layer, and the optimizer state with
    them -- the replicated state under ``opt_state``, ZeRO-1's owned state
    under ``du_opt_state`` -- each layer's as its leaves in JAX order.
    Restarting Adam from zero moments would silently diverge the run."""
    state = {"params": {n: list(trainer.layer_params[n]) for n in trainer.layers},
             "step": int(step)}
    opt = {n: tree_leaves(trainer.opt_state[n]) for n in sorted(trainer.opt_state)}
    if trainer.tree_state is not None:
        opt["tree_state"] = tree_leaves(trainer.tree_state)
    if opt:
        zero1 = trainer.distributed_update and trainer._needs_comm
        state["du_opt_state" if zero1 else "opt_state"] = opt
    return state


@torch.no_grad()
def _apply_state(trainer, state) -> int:
    """Copy a restored state into the trainer's own tensors, in place."""
    want = _trainer_state(trainer, 0)
    for key in ("params", "opt_state", "du_opt_state"):
        if (key in want) != (key in state):
            raise MLSLError(f"checkpoint holds {sorted(state)}, the trainer {sorted(want)}")
        if key not in want:
            continue
        dst, src = tree_leaves(want[key]), tree_leaves(state[key])
        if len(dst) != len(src) or any(d.shape != s.shape or d.dtype != s.dtype
                                       for d, s in zip(dst, src)):
            raise MLSLError(f"checkpoint {key} does not match the trainer's layout")
        for d, s in zip(dst, src):
            d.copy_(s)
    return int(state["step"])


def _trainer_world(trainer) -> Optional[int]:
    dist = getattr(trainer, "dist", None)
    return int(dist.topology.world_size) if dist is not None else None


def save_trainer(mgr: CheckpointManager, trainer, step: int, wait: bool = False,
                 fingerprint: Optional[str] = None) -> None:
    """Persist a DataParallelTrainer's parameters and optimizer state.
    ``fingerprint`` marks the step sentinel-verified; the active world size
    rides in the manifest so a cross-world restore names its mismatch."""
    mgr.save(step, _trainer_state(trainer, step), wait=wait,
             fingerprint=fingerprint, world=_trainer_world(trainer))


def restore_trainer(mgr: CheckpointManager, trainer, step: Optional[int] = None) -> Optional[int]:
    """Restore parameters and optimizer state in place; -> the restored step,
    or None when the directory holds no checkpoint.

    With ``step=None`` the candidates run newest VERIFIED first (steps whose
    manifest records a passing audit fingerprint, newest to oldest), then the
    unverified ones; a step that fails its checksum, or whose restore raises,
    is skipped with a warning. If steps exist but none restores, raise:
    silently restarting from scratch would discard the run."""
    template = _trainer_state(trainer, 0)
    if step is not None:
        state = mgr.restore(step, template=template)
        return None if state is None else _apply_state(trainer, state)
    steps = mgr.all_steps()
    if not steps:
        return None
    mgr._flush_manifests()  # checksum anything committed but unverified
    newest_first = sorted(steps, reverse=True)
    verified = [s for s in newest_first if mgr.recorded_fingerprint(s)]
    unverified = [s for s in newest_first if s not in verified]
    if verified and unverified and unverified[0] > verified[0]:
        log_warning("preferring newest VERIFIED checkpoint step %d over newer unverified "
                    "step %d (no passing audit fingerprint recorded)",
                    verified[0], unverified[0])
    world_now = _trainer_world(trainer)
    for s in verified + unverified:
        if mgr.verify(s) is False:
            log_warning("checkpoint step %d fails checksum verification; falling back", s)
            continue
        w = mgr.recorded_world(s)
        if w is not None and world_now is not None and w != world_now:
            log_warning("checkpoint step %d was saved at world size %d but the active world "
                        "is %d (elastic reshard between save and restore); ZeRO-1 shard "
                        "shapes may not restore", s, w, world_now)
        try:
            state = mgr.restore(s, template=template)
            if state is None:
                continue
            out = _apply_state(trainer, state)
        except Exception as e:
            log_warning("restore of checkpoint step %d failed (%s: %s); falling back",
                        s, type(e).__name__, e)
            continue
        if s != newest_first[0]:
            log_info("restored fallback step %d (latest step %d unusable)", s, newest_first[0])
        return out
    raise MLSLError(f"no restorable checkpoint in {mgr.directory}: all {len(steps)} steps "
                    "are corrupt or unreadable")
