"""Checkpoint save and restore of the flagship's train state on one NVIDIA GPU.

    python -m simpletuner_tpu_torch.bench_checkpoint

The int8 flagship's state (``bench.flagship``'s configuration: full-width,
full-depth Flux.1-dev with an int8 base, rank-16 LoRA, AdamW; seeded
weights made on the card) goes through ``CheckpointManager.save`` twice:
with the whole state, the int8 base's codes and scales included, as the JAX
package saves it, and with the base by reference (its source and checksum,
``checkpoint_frozen_base: reference``).  Each is restored in place into the
same state after its adapters were changed, and must give them back bitwise.
Prints one JSON object last: bytes, seconds and GB/s of each save and
restore, and the card with its power limit.  Writes about 12.4 GB under
``TMPDIR`` and deletes it; the file system's rate, not the card's, bounds it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from typing import Dict

import torch

from .bench import build_run, flagship_config
from .bench_cache import nvidia_smi
from .models.flux import FluxConfig
from .training.checkpoints import CheckpointManager, flatten_state


def measure(run, manager: CheckpointManager, step: int, frozen_source) -> Dict:
    """One save and one in-place restore of ``run.state``."""
    state = run.state
    torch.cuda.synchronize()
    start = time.perf_counter()
    path = manager.save(step, state, {"global_step": step}, frozen_source=frozen_source)
    save_s = time.perf_counter() - start
    nbytes = manager.saves[-1]["bytes"]
    with torch.no_grad():
        expected = {k: t.clone() for k, t in state.trainable.items()}
        for tensor in state.trainable.values():
            tensor.add_(1.0)
    pointers = {k: t.data_ptr() for k, t in flatten_state(state)[0].items()}
    manager.restore(path, state, frozen_source)
    restore_s = manager.restores[-1]["seconds"]
    bitwise = all(torch.equal(state.trainable[k], v) for k, v in expected.items())
    in_place = {k: t.data_ptr() for k, t in flatten_state(state)[0].items()} == pointers
    if not (bitwise and in_place):
        raise RuntimeError(f"checkpoint restore: adapters bitwise {bitwise}, tensors in place {in_place}")
    shutil.rmtree(path)
    return {"bytes": nbytes, "save_s": save_s, "save_gb_per_s": nbytes / save_s / 1e9, "restore_s": restore_s,
            "restore_gb_per_s": nbytes / restore_s / 1e9}


def main(argv=None) -> int:
    argparse.ArgumentParser(prog="python -m simpletuner_tpu_torch.bench_checkpoint",
                            description=__doc__.split("\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_checkpoint: torch.cuda.is_available() is False; the benchmark needs a CUDA device",
              file=sys.stderr)
        return 2
    run = build_run(flagship_config("attn", "int8", "full"), FluxConfig())
    tensors, _ = flatten_state(run.state)
    state_bytes = sum(t.numel() * t.element_size() for t in tensors.values())
    root = tempfile.mkdtemp(prefix="bench_checkpoint_")
    try:
        manager = CheckpointManager(root)
        rows = {"full": measure(run, manager, 1, None),
                "reference": measure(run, manager, 2, {"seed": 0, "quantize": run.model.base_precision})}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({
        "metric": "checkpoint_save_s_h100", "value": rows["full"]["save_s"], "unit": "s per full-state save",
        "extra": {**rows, "state_tensor_bytes": state_bytes, "base_gib": run.base_gib,
                  "device": torch.cuda.get_device_name(0), "card": nvidia_smi()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
