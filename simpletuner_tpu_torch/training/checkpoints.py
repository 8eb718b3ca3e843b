"""Checkpoint save/resume.

Counterpart of ``simpletuner_tpu/training/checkpoints.py``: the same
directory semantics (``checkpoint-N`` and ``rolling-checkpoint-N``, a
``.tmp`` directory renamed into place, ``trainer_state.json``, then
``manifest.json`` with the same keys and ``format_version`` 1, then the
rename, then the ``.checkpoint_complete`` guard; ``total_limit`` and rolling
retention with the cleanup of ``.tmp`` directories; ``async_save`` whose
``wait()`` re-raises a background failure; ``resolve_resume`` for "latest"
or a path).  Remote checkpoints (``s3://``, ``r2://``) are not ported.

The state's format is the port's own, where the JAX package writes an Orbax
tree: ``state/tensors.safetensors`` holds every tensor of the state
(through the port's safetensors writer, ``models/weight_import.py``) under
its path in the state (``module.<name>`` for the module's ``state_dict``:
the frozen base as it is stored, quantized codes and scales included, and
the adapters; ``opt_state.<field>.<key>``, ``ema.<key>``, ``scalars.<field>``),
and ``state/state.json`` holds the rest of the tree: every non-tensor leaf
(the host step, optimizer fields that are numbers) and the tensor paths.
Neither package resumes the other's ``state/``.

Saving the whole state, as the JAX package does, writes the frozen base at
every checkpoint (about 12 GB for Flux with an int8 base).  A save given a
``frozen_source`` (the trainer passes one with the port's own config key
``checkpoint_frozen_base: reference``) writes the base by reference
instead: ``state.json`` records where it came from (the pretrained file's
path, size and modification time, or the seed, and the quantize mode) and a
checksum of its stored tensors, and a restore checks that the target's base
has the same source and checksum and copies only the rest.

:meth:`CheckpointManager.restore` copies the saved tensors into the target
state's own tensors (``copy_``, never rebinding), so that CUDA graphs
captured over the state keep reading valid addresses.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models.weight_import import load_safetensors_file, save_safetensors

logger = logging.getLogger(__name__)

GUARD_FILE = ".checkpoint_complete"
MANIFEST_FILE = "manifest.json"
STATE_DIR = "state"
TENSORS_FILE = "tensors.safetensors"
STATE_JSON = "state.json"
STATE_FORMAT = "simpletuner_tpu_torch/1"


def flatten_state(node: Any, prefix: str = "") -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(tensors, leaves): every tensor of a state tree by its dotted path, and
    every other leaf (numbers, strings, None) by its path.  Dataclasses and
    dicts are walked by field / key; an ``nn.Module`` contributes its
    ``state_dict`` (parameters and buffers).  A tensor met twice (a
    ``TrainState``'s adapters sit in its module and in ``trainable``) is kept
    at its first path only."""
    tensors: Dict[str, torch.Tensor] = {}
    leaves: Dict[str, Any] = {}
    seen = set()

    def add(path: str, tensor: torch.Tensor) -> None:
        if id(tensor) not in seen:
            seen.add(id(tensor))
            tensors[path] = tensor

    def walk(value: Any, path: str) -> None:
        if isinstance(value, torch.Tensor):
            add(path, value)
        elif isinstance(value, nn.Module):
            for name, tensor in value.state_dict(keep_vars=True).items():
                add(f"{path}.{name}" if path else name, tensor)
        elif dataclasses.is_dataclass(value) and not isinstance(value, type):
            for field in dataclasses.fields(value):
                walk(getattr(value, field.name), f"{path}.{field.name}" if path else field.name)
        elif isinstance(value, dict):
            for key in sorted(value):
                walk(value[key], f"{path}.{key}" if path else str(key))
        elif value is None or isinstance(value, (bool, int, float, str)):
            leaves[path] = value
        else:
            raise TypeError(f"{path}: a {type(value).__name__} has no place in a checkpoint")

    walk(node, prefix)
    return tensors, leaves


def frozen_paths(state: Any) -> List[str]:
    """The paths of a ``TrainState``'s frozen tensors: the module's
    parameters and buffers that are not trainable adapters."""
    trainable = {id(t) for t in getattr(state, "trainable", {}).values()}
    return sorted(f"module.{name}" for name, tensor in state.module.state_dict(keep_vars=True).items()
                  if id(tensor) not in trainable)


@torch.no_grad()
def tensor_checksum(tensors: List[torch.Tensor]) -> str:
    """An exact checksum of the tensors' bytes, computed where they live:
    the sum of every byte times (its index mod 65521) + 1, per tensor, and
    their shapes and dtypes."""
    total, layout = 0, []
    for tensor in tensors:
        data = tensor.detach().contiguous().reshape(-1).view(torch.uint8)
        weights = torch.arange(data.numel(), device=data.device, dtype=torch.int32).remainder_(65521).add_(1)
        total += int((data.to(torch.int64) * weights).sum())
        layout.append(f"{tensor.dtype}{tuple(tensor.shape)}")
    return f"{total}:{_hash_text(';'.join(layout))}"


def _hash_text(text: str) -> str:
    import hashlib

    return hashlib.sha256(text.encode()).hexdigest()[:16]


def save_state(state: Any, directory: str, frozen_source: Optional[Dict[str, Any]] = None) -> int:
    """Write ``state`` under ``directory``; returns the bytes written.  With
    ``frozen_source`` the frozen base is written by reference (its source
    and checksum), not its tensors."""
    os.makedirs(directory, exist_ok=True)
    tensors, leaves = flatten_state(state)
    meta: Dict[str, Any] = {"format": STATE_FORMAT, "leaves": leaves}
    if frozen_source is not None:
        frozen = frozen_paths(state)
        meta["frozen"] = {"source": frozen_source, "tensors": frozen,
                          "checksum": tensor_checksum([tensors[p] for p in frozen])}
        tensors = {path: t for path, t in tensors.items() if path not in set(frozen)}
    meta["tensors"] = sorted(tensors)
    save_safetensors({path: tensor.detach() for path, tensor in tensors.items()},
                     os.path.join(directory, TENSORS_FILE), metadata={"format": STATE_FORMAT})
    with open(os.path.join(directory, STATE_JSON), "w") as handle:
        json.dump(meta, handle)
    return sum(os.path.getsize(os.path.join(directory, name)) for name in (TENSORS_FILE, STATE_JSON))


@torch.no_grad()
def restore_state(directory: str, target: Any, frozen_source: Optional[Dict[str, Any]] = None) -> Any:
    """Copy the state saved under ``directory`` into ``target``, in place:
    every tensor of the target takes the saved values through ``copy_``
    (same shape and dtype, or this raises), and every non-tensor leaf that a
    dataclass or dict holds is set to the saved value.  A frozen base saved
    by reference is not copied: the target's must come from the same source
    (``frozen_source``) and have the same checksum.  Returns ``target``."""
    with open(os.path.join(directory, STATE_JSON)) as handle:
        meta = json.load(handle)
    if meta.get("format") != STATE_FORMAT:
        raise ValueError(f"{directory}: state format {meta.get('format')!r} is not {STATE_FORMAT!r} "
                         "(an Orbax state of the JAX package does not resume in the port)")
    saved = load_safetensors_file(os.path.join(directory, TENSORS_FILE))
    tensors, leaves = flatten_state(target)
    frozen = meta.get("frozen")
    if frozen is not None:
        if frozen["source"] != frozen_source:
            raise ValueError(f"{directory}: the checkpoint's frozen base came from {frozen['source']}, the "
                             f"target's from {frozen_source}")
        if frozen["tensors"] != frozen_paths(target) or \
                frozen["checksum"] != tensor_checksum([tensors[p] for p in frozen["tensors"]]):
            raise ValueError(f"{directory}: the target's frozen base differs from the one the checkpoint refers to")
        tensors = {path: t for path, t in tensors.items() if path not in set(frozen["tensors"])}
    if set(saved) != set(tensors) or set(meta["leaves"]) != set(leaves):
        missing = sorted(set(tensors) - set(saved)) + sorted(set(leaves) - set(meta["leaves"]))
        extra = sorted(set(saved) - set(tensors)) + sorted(set(meta["leaves"]) - set(leaves))
        raise ValueError(f"{directory}: the saved state does not fit the target: missing {missing[:8]}, "
                         f"unexpected {extra[:8]}")
    for path, tensor in tensors.items():
        value = saved[path]
        if value.shape != tensor.shape or value.dtype != tensor.dtype:
            raise ValueError(f"{directory}: {path} is {value.dtype}{tuple(value.shape)}, the target "
                             f"{tensor.dtype}{tuple(tensor.shape)}")
        tensor.copy_(value)
    for path, value in meta["leaves"].items():
        _set_leaf(target, path.split("."), value)
    return target


def _set_leaf(node: Any, parts: List[str], value: Any) -> None:
    for part in parts[:-1]:
        node = node[part] if isinstance(node, dict) else getattr(node, part)
    if isinstance(node, dict):
        node[parts[-1]] = value
    elif getattr(node, parts[-1]) != value:
        object.__setattr__(node, parts[-1], value)  # frozen dataclasses too


class CheckpointManager:
    def __init__(
        self,
        output_dir: str,
        total_limit: Optional[int] = None,
        rolling_total_limit: int = 1,
        async_save: bool = False,
    ):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.total_limit = total_limit
        self.rolling_total_limit = rolling_total_limit
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None  # in-flight async finalize thread
        self._pending_error: Optional[BaseException] = None  # raised by a background finalize
        # what each save and restore took: {"path", "seconds", "bytes"}
        self.saves: List[Dict[str, Any]] = []
        self.restores: List[Dict[str, Any]] = []

    # ---- paths --------------------------------------------------------------------------
    def path_for_step(self, step: int, rolling: bool = False) -> str:
        suffix = f"rolling-checkpoint-{step}" if rolling else f"checkpoint-{step}"
        return os.path.join(self.output_dir, suffix)

    def list_checkpoints(self, rolling: bool = False) -> List[str]:
        prefix = "rolling-checkpoint-" if rolling else "checkpoint-"
        found = []
        for name in os.listdir(self.output_dir):
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                path = os.path.join(self.output_dir, name)
                if os.path.exists(os.path.join(path, GUARD_FILE)):
                    found.append(path)
        return sorted(found, key=lambda p: int(p.rsplit("-", 1)[1]))

    def latest_checkpoint(self) -> Optional[str]:
        complete = self.list_checkpoints() + self.list_checkpoints(rolling=True)
        if not complete:
            return None
        return max(complete, key=lambda p: int(p.rsplit("-", 1)[1]))

    def resolve_resume(self, resume_from: Optional[str]) -> Optional[str]:
        if not resume_from or resume_from in ("none", "false"):
            return None
        if resume_from == "latest":
            return self.latest_checkpoint()
        if str(resume_from).startswith(("s3://", "r2://")):
            raise NotImplementedError(
                f"remote checkpoint {resume_from!r}: remote resume is not ported (ROADMAP Queue 1 item 4j)")
        path = resume_from if os.path.isabs(resume_from) else os.path.join(self.output_dir, resume_from)
        return path if os.path.isdir(path) else None

    # ---- save ----------------------------------------------------------------------------
    def save(
        self,
        step: int,
        state,
        extra_state: Optional[Dict[str, Any]] = None,
        rolling: bool = False,
        on_complete: Optional[Callable[[str], None]] = None,
        frozen_source: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Atomic: write to a tmp dir, then ``trainer_state.json`` and the
        manifest, rename, then the guard file.  The state's tensors are
        written before this returns (the caller's next step changes them in
        place); with ``async_save`` the finalize (manifest, rename, guard,
        retention, ``on_complete``) runs on a background thread, and the next
        save joins it first.  ``frozen_source``: write the frozen base by
        reference (see the module docstring)."""
        self.wait()
        final_path = self.path_for_step(step, rolling)
        tmp_path = final_path + ".tmp"
        if os.path.exists(tmp_path):
            shutil.rmtree(tmp_path)
        if os.path.exists(final_path):
            shutil.rmtree(final_path)
        os.makedirs(tmp_path, exist_ok=True)
        start = time.perf_counter()
        nbytes = save_state(state, os.path.join(tmp_path, STATE_DIR), frozen_source)
        self.saves.append({"path": final_path, "seconds": time.perf_counter() - start, "bytes": nbytes})

        def finalize():
            if extra_state:
                with open(os.path.join(tmp_path, "trainer_state.json"), "w") as handle:
                    json.dump(extra_state, handle)
            files = []
            for root, _dirs, names in os.walk(tmp_path):
                for name in names:
                    if name == MANIFEST_FILE:
                        continue
                    files.append(os.path.relpath(os.path.join(root, name), tmp_path))
            manifest = {
                "step": step,
                "rolling": rolling,
                "created_at": time.time(),
                "format_version": 1,
                "files": sorted(files),
            }
            with open(os.path.join(tmp_path, MANIFEST_FILE), "w") as handle:
                json.dump(manifest, handle)
            os.replace(tmp_path, final_path)
            with open(os.path.join(final_path, GUARD_FILE), "w") as handle:
                handle.write(str(step))
            self._cleanup(rolling)
            if on_complete is not None:
                on_complete(final_path)

        if self.async_save:
            def guarded_finalize():
                # Thread.join never re-raises: keep the failure for wait()
                try:
                    finalize()
                except BaseException as exc:  # noqa: BLE001
                    self._pending_error = exc

            self._pending = threading.Thread(target=guarded_finalize, daemon=True)
            self._pending.start()
        else:
            finalize()
        return final_path

    def wait(self) -> None:
        """Join any in-flight async save (call before resume/exit); re-raises a
        background finalize failure."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            error, self._pending_error = self._pending_error, None
            raise RuntimeError("async checkpoint finalize failed") from error

    def _cleanup(self, rolling: bool) -> None:
        limit = self.rolling_total_limit if rolling else self.total_limit
        if not limit or limit <= 0:
            return
        checkpoints = self.list_checkpoints(rolling=rolling)
        for path in checkpoints[:-limit]:
            shutil.rmtree(path, ignore_errors=True)
        # incomplete (unguarded) temp dirs go too (reference trainer.py:4605-4635)
        for name in os.listdir(self.output_dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.output_dir, name), ignore_errors=True)

    # ---- restore --------------------------------------------------------------------------
    def restore(self, path: str, target_state, frozen_source: Optional[Dict[str, Any]] = None):
        """Copy the checkpoint's state into ``target_state`` in place; returns
        (target_state, the trainer_state.json dict)."""
        self.wait()
        start = time.perf_counter()
        restore_state(os.path.join(path, STATE_DIR), target_state, frozen_source)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.restores.append({"path": path, "seconds": time.perf_counter() - start})
        extra_path = os.path.join(path, "trainer_state.json")
        extra = {}
        if os.path.exists(extra_path):
            with open(extra_path) as handle:
                extra = json.load(handle)
        return target_state, extra
