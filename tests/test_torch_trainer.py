"""The port's trainer runtime against the JAX ``Trainer``, on the CPU.

* **Against JAX.**  The JAX ``Trainer`` runs 4 steps of tiny Flux with
  ``checkpointing_steps: 2``; the port's ``Trainer(device="cpu")`` runs the
  same config on the same cache directory (both packages' caches share one
  on-disk format, so the port reads the latents and embeds the JAX run
  wrote; the captions' embeds are seeded into that cache before either run,
  as the tiny tokenizer hashes words differently in every process).  Both
  load one seeded tiny Flux file through
  ``pretrained_model_name_or_path`` and warm-start one seeded adapter file
  through ``init_lora``; both draw the same numpy noise and sigmas per step
  through the ``override_noise`` / ``override_sigmas`` batch hooks, which the
  test wraps around each package's iterator.  Per-step loss and grad norm
  agree within ``TRAJECTORY_TOL`` (relative); ``trainer_state.json`` is
  equal, the manifests list the same files outside ``state/``, and the
  port's LoRA export loads through the JAX loader and matches the JAX export
  within ``TRAJECTORY_TOL`` in relative L2.
* **Resume.**  On the port, 4 straight steps equal 2 steps, a save, a fresh
  ``Trainer`` with ``resume_from_checkpoint: latest`` and 2 more, bitwise:
  losses, the LoRA export and the whole saved state (base, adapters,
  optimizer state, EMA), with the base written into the checkpoint (as the
  JAX package writes it) or referred to by source and checksum
  (``checkpoint_frozen_base: reference``).  ``restore`` copies into the
  state's tensors in place and refuses a base that is not the one referred
  to.
* **Checkpoint manager against JAX.**  One sequence of saves (interval,
  rolling, ``checkpoints_total_limit`` 2, an orphaned ``.tmp``) leaves the
  same listings outside ``state/`` and the same ``latest_checkpoint`` /
  ``resolve_resume`` answers; a failing async finalize re-raises from
  ``wait()``.
* **Entry.**  ``python -m simpletuner_tpu_torch.train --config ... --device
  cpu`` trains 2 steps from an empty cache; configs with another family or
  an unported option exit non-zero naming their ROADMAP item.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
from simpletuner_tpu.training.checkpoints import CheckpointManager as JaxCheckpointManager
from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora
from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
from simpletuner_tpu.training import trainer as jax_trainer_module
from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
from simpletuner_tpu_torch.configuration import TrainingConfig
from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
from simpletuner_tpu_torch.models.checkpoint_layouts import flux_checkpoint_shapes
from simpletuner_tpu_torch.models.flux import Flux
from simpletuner_tpu_torch.models.layers import lora_parameters
from simpletuner_tpu_torch.models.weight_import import load_safetensors_file, save_safetensors
from simpletuner_tpu_torch.training.checkpoints import CheckpointManager, flatten_state
from simpletuner_tpu_torch.training.lora import save_lora_safetensors
from simpletuner_tpu_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
METRICS = "simpletuner-tpu-metrics.jsonl"
# per-step loss and grad norm, port against JAX, f32 on both sides: the
# 30-step trajectory test of the train step measured 1e-6
TRAJECTORY_TOL = 1e-5


def _seeded(shapes, seed):
    """f32 checkpoint tensors: N(0, 1/fan_in) matrices, 1 + N(0, 0.1) norm weights, N(0, 0.1) biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        draw = rng.standard_normal(shape).astype(np.float32)
        if len(shape) > 1:
            draw /= np.sqrt(np.prod(shape[1:]))
        elif name.endswith(".weight"):
            draw = 1.0 + 0.1 * draw
        else:
            draw = 0.1 * draw
        out[name] = draw
    return out


def _write_images(directory, count=4):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(count):
        size = (96, 64) if i % 2 else (64, 64)
        Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(
            os.path.join(directory, f"i_{i}.png"))
        with open(os.path.join(directory, f"i_{i}.txt"), "w") as handle:
            handle.write(f"photo {i}")


def _values(root, out, **extra):
    """The tiny recipe: tiny Flux, 4 images at 32 px in two aspect buckets, rank 4."""
    values = {
        "model_family": "flux", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
        "optimizer": "adamw", "learning_rate": 1e-3, "lr_scheduler": "constant", "max_train_steps": 4,
        "train_batch_size": 1, "resolution": 32, "report_to": "jsonl", "mixed_precision": "fp32",
        "vae_dtype": "fp32", "tokenizer_max_length": 16, "cache_dir": str(root / "cache"),
        "output_dir": str(root / out), "checkpointing_steps": 2, "seed": 42,
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": str(root / "data"),
             "resolution": 32, "resolution_type": "pixel_area", "aspect_bucket_alignment": 16,
             "caption_strategy": "textfile", "cache_dir_vae": str(root / "cache" / "vae"), "repeats": 1},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": str(root / "cache" / "text")},
        ],
    }
    values.update(extra)
    return values


def _overriding(original):
    """``next_batch`` with the same numpy noise and sigmas for step ``step`` on both sides."""

    def next_batch(self, step=0):
        batch = dict(original(self, step=step))
        rng = np.random.default_rng(1000 + step)
        batch["override_noise"] = rng.standard_normal(batch["latents"].shape).astype(np.float32)
        batch["override_sigmas"] = rng.uniform(0.05, 0.95, batch["latents"].shape[0]).astype(np.float32)
        return batch

    return next_batch


def _metrics(output_dir):
    with open(os.path.join(output_dir, METRICS)) as handle:
        return [json.loads(line) for line in handle]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    _write_images(root / "data")
    port_model = Flux(TrainingConfig(_values(root, "x")))
    flux_path = str(root / "flux.safetensors")
    save_safetensors(_seeded(flux_checkpoint_shapes(port_model.arch), seed=3), flux_path)
    # a seeded adapter for init_lora: every A and B nonzero
    module = port_model.create_module()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for param in lora_parameters(module).values():
            param.copy_(torch.randn(param.shape, generator=gen) * 0.05)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, module, lora_path)
    extra = {"pretrained_model_name_or_path": flux_path, "init_lora": lora_path}
    # the captions' embeds, cached before either run: the tiny tokenizer's
    # salted hash would give every process other embeds (and other rounding)
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "flux")
    rng = np.random.default_rng(5)
    for i in range(4):
        mask = (np.arange(16) < 3 + i).astype(np.int32)
        cache.save(f"photo {i}", {"t5_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                  "pooled_embeds": rng.standard_normal(32).astype(np.float32),
                                  "attention_mask": mask})

    with pytest.MonkeyPatch.context() as mp:
        # the JAX trainer on one device, as the port trains (the test session has 8 CPU devices)
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(_values(root, "jax", **extra)))
        jax_trainer.run()
        # the port on the cache the JAX run wrote (latents and embeds are read, not encoded)
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=_values(root, "port", **extra), device="cpu")
        port_trainer.run()
    return root, jax_trainer, port_trainer


def test_trajectory_matches_jax(runs):
    root, _, _ = runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2, 3, 4]
    for a, b in zip(ours, theirs):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= TRAJECTORY_TOL * max(1.0, abs(b[key])), (a["step"], key, a[key], b[key])
        assert b["grad_norm"] > 0 and a["lr"] == pytest.approx(b["lr"], rel=1e-7)


def test_checkpoints_match_jax(runs):
    root, _, _ = runs
    for step in (2, 4):
        ours, theirs = root / "port" / f"checkpoint-{step}", root / "jax" / f"checkpoint-{step}"
        with open(ours / "trainer_state.json") as a, open(theirs / "trainer_state.json") as b:
            assert json.load(a) == json.load(b)
        with open(ours / "manifest.json") as a, open(theirs / "manifest.json") as b:
            mine, jax_manifest = json.load(a), json.load(b)
        assert sorted(mine) == sorted(jax_manifest) and mine["format_version"] == jax_manifest["format_version"] == 1
        assert [f for f in mine["files"] if not f.startswith("state/")] == \
            [f for f in jax_manifest["files"] if not f.startswith("state/")] == ["trainer_state.json"]
        assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))


def test_lora_export_loads_in_jax(runs):
    root, jax_trainer, _ = runs
    template = jax.device_get(jax_trainer._state.trainable["lora"])
    ours = jax_load_lora(jax_trainer.model, str(root / "port" / "checkpoint-4" / "pytorch_lora_weights.safetensors"),
                         template)
    theirs = jax_load_lora(jax_trainer.model, str(root / "jax" / "checkpoint-4" / "pytorch_lora_weights.safetensors"),
                           template)
    leaves_ours = jax.tree_util.tree_leaves_with_path(ours)
    leaves_theirs = dict(jax.tree_util.tree_leaves_with_path(theirs))
    assert len(leaves_ours) == len(leaves_theirs) > 0
    # the whole adapter in relative L2: Adam's normalised steps make a few
    # elements with near-zero gradients move by more than their share
    diff = sum(float(np.sum((np.asarray(v) - np.asarray(leaves_theirs[p])) ** 2)) for p, v in leaves_ours)
    norm = sum(float(np.sum(np.asarray(v) ** 2)) for v in leaves_theirs.values())
    assert diff ** 0.5 <= TRAJECTORY_TOL * norm ** 0.5


@pytest.mark.parametrize("frozen", ["full", "reference"])
def test_resume_is_bitwise_the_straight_run(tmp_path, frozen):
    _write_images(tmp_path / "data")
    mode = {"use_ema": True, "checkpoint_frozen_base": frozen}
    straight = Trainer(config=_values(tmp_path, "straight", **mode), device="cpu")
    straight.run()

    first = Trainer(config=_values(tmp_path, "resumed", **mode), device="cpu")
    record = first.iteration_tracker.record_step

    def stop_after_two():
        record()
        if first.global_step == 2:
            first.abort()

    first.iteration_tracker.record_step = stop_after_two
    first.run()
    assert first.global_step == 2
    resumed = Trainer(config=_values(tmp_path, "resumed", resume_from_checkpoint="latest", **mode), device="cpu")
    resumed.run()
    assert resumed.global_step == 4

    a, b = _metrics(tmp_path / "straight"), _metrics(tmp_path / "resumed")
    assert [m["step"] for m in b] == [1, 2, 3, 4]
    assert [(m["loss"], m["grad_norm"]) for m in a] == [(m["loss"], m["grad_norm"]) for m in b]
    for name in ("pytorch_lora_weights.safetensors", "state/tensors.safetensors"):
        ours = load_safetensors_file(str(tmp_path / "resumed" / "checkpoint-4" / name))
        theirs = load_safetensors_file(str(tmp_path / "straight" / "checkpoint-4" / name))
        assert sorted(ours) == sorted(theirs)
        assert all(torch.equal(ours[k], theirs[k]) for k in ours), name
    assert any(k.startswith("opt_state.") for k in ours) and any(k.startswith("ema.") for k in ours)
    # the base is in the file, or referred to by source and checksum
    assert ("module.img_in.weight" in ours) == (frozen == "full")

    # restore copies into the state's own tensors
    tensors, _ = flatten_state(resumed._state)
    pointers = {k: t.data_ptr() for k, t in tensors.items()}
    checkpoint = str(tmp_path / "straight" / "checkpoint-2")
    resumed.checkpoint_manager.restore(checkpoint, resumed._state, resumed._frozen_source)
    saved = load_safetensors_file(os.path.join(checkpoint, "state", "tensors.safetensors"))
    tensors, _ = flatten_state(resumed._state)
    assert {k: t.data_ptr() for k, t in tensors.items()} == pointers
    assert all(torch.equal(tensors[k], saved[k]) for k in saved) and resumed._state.step == 2
    if frozen == "reference":  # a base from elsewhere, or changed, is refused
        with pytest.raises(ValueError, match="came from"):
            resumed.checkpoint_manager.restore(checkpoint, resumed._state, {"seed": 1})
        with torch.no_grad():
            resumed._state.module.img_in.weight.add_(1.0)
        with pytest.raises(ValueError, match="differs"):
            resumed.checkpoint_manager.restore(checkpoint, resumed._state, resumed._frozen_source)


def test_prefetch_and_epoch_hooks(tmp_path):
    # dataloader_prefetch trains the same sequence as the inline draw; one
    # epoch is 4 batches, so the epoch hooks fire after step 5
    _write_images(tmp_path / "data")
    losses = {}
    for prefetch in (False, True):
        values = _values(tmp_path, f"out_{prefetch}", max_train_steps=6, checkpointing_steps=None,
                         checkpoint_epoch_interval=1, validation_epoch_interval=1, validation_prompt="a photo",
                         validation_resolution=64, validation_num_inference_steps=2, dataloader_prefetch=prefetch)
        values["data_backend_config"][0]["repeats"] = 0
        trainer = Trainer(config=values, device="cpu")
        trainer.run()
        losses[prefetch] = [(m["loss"], m["epoch"]) for m in _metrics(tmp_path / f"out_{prefetch}")]
        out = tmp_path / f"out_{prefetch}"
        assert sorted(n for n in os.listdir(out) if n.startswith("checkpoint")) == ["checkpoint-5", "checkpoint-6"]
        assert (out / "validation" / "step_5_0.png").exists() and (out / "validation" / "step_6_0.png").exists()
        with open(out / "checkpoint-5" / "trainer_state.json") as handle:
            assert json.load(handle)["epoch"] == 1
    assert losses[True] == losses[False] and [e for _, e in losses[False]] == [0, 0, 0, 0, 1, 1]


def test_sigterm_checkpoints_and_stops(tmp_path):
    import signal

    _write_images(tmp_path / "data")
    trainer = Trainer(config=_values(tmp_path, "out", validation_prompt="a photo", validation_resolution=64,
                                     validation_num_inference_steps=2), device="cpu")
    record = trainer.iteration_tracker.record_step

    def preempt_at_three():
        record()
        if trainer.global_step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer.iteration_tracker.record_step = preempt_at_three
    previous = signal.getsignal(signal.SIGTERM)
    trainer.run()
    assert signal.getsignal(signal.SIGTERM) == previous  # the handler is put back
    assert trainer._preempted and trainer.global_step == 3
    out = tmp_path / "out"
    assert sorted(os.listdir(out / "checkpoint-3")) == [".checkpoint_complete", "manifest.json",
                                                         "pytorch_lora_weights.safetensors", "state",
                                                         "trainer_state.json"]
    assert not (out / "validation").exists()  # a preempted run skips the final render


def test_checkpoint_manager_matches_jax(tmp_path):
    import jax.numpy as jnp

    managers = {
        "port": (CheckpointManager(str(tmp_path / "port"), total_limit=2), {"w": torch.zeros(3), "step": 0}),
        "jax": (JaxCheckpointManager(str(tmp_path / "jax"), total_limit=2), {"w": jnp.zeros(3)}),
    }
    answers = {}
    for side, (manager, state) in managers.items():
        os.makedirs(os.path.join(manager.output_dir, "checkpoint-7.tmp"))  # an orphan of a killed save
        for step, rolling in ((2, False), (3, True), (4, False), (5, True), (6, False), (8, False)):
            manager.save(step, state, {"global_step": step}, rolling=rolling)
        listing = {}
        for name in sorted(os.listdir(manager.output_dir)):
            path = os.path.join(manager.output_dir, name)
            listing[name] = sorted(f for f in os.listdir(path) if f != "state")
        answers[side] = (listing, os.path.basename(manager.latest_checkpoint()),
                         os.path.basename(manager.resolve_resume("latest")),
                         os.path.basename(manager.resolve_resume("checkpoint-6")),
                         manager.resolve_resume("checkpoint-2"), manager.resolve_resume("none"),
                         [os.path.basename(p) for p in manager.list_checkpoints(rolling=True)])
    assert answers["port"] == answers["jax"]
    assert sorted(answers["port"][0]) == ["checkpoint-6", "checkpoint-8", "rolling-checkpoint-5"]
    with pytest.raises(NotImplementedError, match="item 4j"):
        managers["port"][0].resolve_resume("s3://bucket/run/checkpoint-2")

    manager = CheckpointManager(str(tmp_path / "async"), async_save=True)

    def fail(path):
        raise OSError("disk full")

    manager.save(1, {"w": torch.zeros(2)}, {"global_step": 1}, on_complete=fail)
    with pytest.raises(RuntimeError, match="async checkpoint finalize failed"):
        manager.wait()
    manager.wait()  # the failure is reported once


def test_entry_trains_from_an_empty_cache(tmp_path):
    _write_images(tmp_path / "data")
    config = tmp_path / "cfg.json"
    config.write_text(json.dumps(_values(tmp_path, "out", max_train_steps=2, validation_prompt="a photo",
                                         validation_resolution=64, validation_num_inference_steps=2)))
    result = subprocess.run([sys.executable, "-m", "simpletuner_tpu_torch.train", "--config", str(config),
                             "--device", "cpu"], cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-3000:]
    out = tmp_path / "out"
    assert [m["step"] for m in _metrics(out)] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in _metrics(out))
    checkpoint = out / "checkpoint-2"
    assert {".checkpoint_complete", "manifest.json", "trainer_state.json", "pytorch_lora_weights.safetensors",
            "state"} <= set(os.listdir(checkpoint))
    assert (out / "validation" / "step_2_0.png").exists() and (out / "README.md").exists()
    assert os.listdir(tmp_path / "cache" / "text") and os.listdir(tmp_path / "cache" / "vae")


def test_entry_refuses_another_family(tmp_path):
    config = tmp_path / "cfg.json"
    config.write_text(json.dumps(_values(tmp_path, "out", model_family="deepfloyd")))
    result = subprocess.run([sys.executable, "-m", "simpletuner_tpu_torch.train", "--config", str(config),
                             "--device", "cpu"], cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                            capture_output=True, text=True, timeout=600)
    assert result.returncode != 0 and "ROADMAP Queue 1 item 6" in result.stderr


@pytest.mark.parametrize("change, item", [
    ({"crepa_enabled": True}, "ROADMAP Queue 1 item 4h"),
    ({"distillation_method": "lcm"}, "ROADMAP Queue 1 item 4g"),
    ({"model_type": "full"}, "ROADMAP Queue 1 item 7"),
    ({"push_to_hub": True}, "ROADMAP Queue 1 item 4j"),
    ({"validation_prompt": "a", "validation_using_datasets": True}, "ROADMAP Queue 1 item 4d"),
], ids=["crepa", "distillation", "full", "hub", "img2img"])
def test_unported_options_are_refused(tmp_path, change, item):
    _write_images(tmp_path / "data")
    with pytest.raises(NotImplementedError, match=item):
        Trainer(config=_values(tmp_path, "out", max_train_steps=1, **change), device="cpu").run()
    assert not os.path.exists(tmp_path / "out" / METRICS)


def test_checkpoint_bench_needs_the_card():
    from simpletuner_tpu_torch import bench_checkpoint

    if torch.cuda.is_available():
        pytest.skip("on a card the benchmark writes 12 GB: run it as python -m simpletuner_tpu_torch.bench_checkpoint")
    assert bench_checkpoint.main([]) == 2


# ---- the eval loss and checkpoint inference, against the JAX Trainer -----------------------------

EVAL_PROMPT = "a red cube on a table"


def _stand_in_text(self, prompts):
    """Each prompt's Flux payload from a generator seeded by its md5: the same
    embeds on both sides and in every process."""
    import hashlib

    out = []
    for prompt in prompts:
        rng = np.random.default_rng(int(hashlib.md5(prompt.encode()).hexdigest()[:8], 16))
        mask = (np.arange(16) < min(len(prompt.split()) + 1, 16)).astype(np.int32)
        out.append({"t5_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                    "pooled_embeds": rng.standard_normal(32).astype(np.float32), "attention_mask": mask})
    return out


def _eval_overrides(calls):
    """``collate_batch`` with the same numpy noise and sigmas on both sides, per eval batch in order."""

    def wrap(collate):
        def collate_batch(samples, bundle, model, *args, **kwargs):
            batch = collate(samples, bundle, model, *args, **kwargs)
            rng = np.random.default_rng(2000 + len(calls))
            calls.append([s["image_path"] for s in samples])
            batch["override_noise"] = rng.standard_normal(batch["latents"].shape).astype(np.float32)
            batch["override_sigmas"] = rng.uniform(0.05, 0.95, batch["latents"].shape[0]).astype(np.float32)
            return batch

        return collate_batch

    return wrap


def _port_noise_render(original):
    """The JAX ``_render_single`` with the port's validation noise for (seed, index)."""
    import jax.numpy as jnp

    from simpletuner_tpu_torch.training.validation import noise_generator

    def render_single(self, variables, embeds, index):
        noise = torch.randn(self._latent_shape(1), generator=noise_generator(self.seed, index)).numpy()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
            return original(self, variables, embeds, index)

    return render_single


@pytest.fixture(scope="module")
def eval_runs(runs):
    """The ``runs`` configuration with an eval split (two more images,
    ``dataset_type: eval``, ``eval_steps_interval: 2``), a validation prompt
    and a seeded VAE file, on both sides; then each package's
    ``run_inference`` on its own ``checkpoint-4``."""
    from simpletuner_tpu import inference as jax_inference
    from simpletuner_tpu.data import dataset as jax_dataset
    from simpletuner_tpu.models.flux.model import Flux as JaxFlux
    from simpletuner_tpu.training import evaluation as jax_evaluation
    from simpletuner_tpu.training.validation import Validation as JaxValidation

    from simpletuner_tpu_torch import inference
    from simpletuner_tpu_torch.models.checkpoint_layouts import vae_checkpoint_shapes
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from simpletuner_tpu_torch.training import evaluation

    root = runs[0]
    _write_images(root / "held", count=2)
    for i in range(2):
        os.replace(root / "held" / f"i_{i}.txt", root / "held" / f"e_{i}.txt")
        os.replace(root / "held" / f"i_{i}.png", root / "held" / f"e_{i}.png")
        (root / "held" / f"e_{i}.txt").write_text(f"held out {i}")
    (root / "vaemodel" / "vae").mkdir(parents=True)
    save_safetensors(_seeded(vae_checkpoint_shapes(AutoencoderKL(VAEConfig.tiny())), seed=6),
                     str(root / "vaemodel" / "vae" / "diffusion_pytorch_model.safetensors"))

    def values(out):
        config = _values(root, out, pretrained_model_name_or_path=str(root / "flux.safetensors"),
                         init_lora=str(root / "init_lora.safetensors"), eval_steps_interval=2,
                         validation_prompt=EVAL_PROMPT, validation_resolution=64, validation_num_inference_steps=2,
                         disable_benchmark=True, pretrained_vae_model_name_or_path=str(root / "vaemodel"))
        config["data_backend_config"].insert(1, {
            "id": "held", "dataset_type": "eval", "type": "local", "instance_data_dir": str(root / "held"),
            "resolution": 32, "resolution_type": "pixel_area", "aspect_bucket_alignment": 16,
            "caption_strategy": "textfile", "cache_dir_vae": str(root / "cache" / "vae_held")})
        return config

    calls = {"jax": [], "port": []}
    renders = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        mp.setattr(JaxFlux, "encode_text", _stand_in_text)
        mp.setattr(Flux, "encode_text", _stand_in_text)
        mp.setattr(JaxValidation, "_render_single", _port_noise_render(JaxValidation._render_single))
        execute = jax_evaluation.EvalLoss.execute_eval

        def jax_execute(self, variables):
            with pytest.MonkeyPatch.context() as m:
                m.setattr(jax_dataset, "collate_batch", _eval_overrides(calls["jax"])(jax_dataset.collate_batch))
                return execute(self, variables)

        mp.setattr(jax_evaluation.EvalLoss, "execute_eval", jax_execute)
        mp.setattr(evaluation, "collate_batch", _eval_overrides(calls["port"])(evaluation.collate_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(values("jax_eval")))
        jax_trainer.run()
        port_trainer = Trainer(config=values("port_eval"), device="cpu")
        port_trainer.run()
        config_path = root / "eval_config.json"
        config_path.write_text(json.dumps(values("unused")))
        for side, run in (("jax", jax_inference.run_inference), ("port", inference.run_inference)):
            kwargs = {} if side == "jax" else {"device": "cpu"}
            assert run(checkpoint=str(root / f"{side}_eval" / "checkpoint-4"), prompt=EVAL_PROMPT,
                       config_path=str(config_path), output=str(root / f"{side}_render"), steps=2,
                       resolution=64, seed=42, **kwargs) == 0
    return root, calls, jax_trainer, port_trainer


def test_eval_loss_matches_jax(eval_runs):
    root, calls, _, port_trainer = eval_runs
    ours = [m for m in _metrics(root / "port_eval") if "eval_loss" in m]
    theirs = [m for m in _metrics(root / "jax_eval") if "eval_loss" in m]
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [2, 4]
    for a, b in zip(ours, theirs):
        assert np.isfinite(a["eval_loss"]) and abs(a["eval_loss"] - b["eval_loss"]) <= TRAJECTORY_TOL * abs(b["eval_loss"])
    # both evaluators read the same batches: the eval split's two images, once per eval
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 4
    assert all(os.path.basename(p).startswith("e_") for batch in calls["port"] for p in batch)
    assert [r["step"] for r in port_trainer.eval_report] == [2, 4]


def test_eval_split_leaves_the_training_losses(runs, eval_runs):
    """The eval split never enters the train iterator: on each side the
    training losses with it are bitwise those without it."""
    root = runs[0]
    for side in ("jax", "port"):
        without = [(m["loss"], m["grad_norm"]) for m in _metrics(root / side)]
        with_eval = [(m["loss"], m["grad_norm"]) for m in _metrics(root / f"{side}_eval") if "loss" in m]
        assert with_eval == without, side


def test_checkpoint_inference_renders_the_final_validation(eval_runs):
    """Each package's run_inference on its own checkpoint-4 renders its
    trainer's final validation image bitwise; the port's render matches the
    JAX one within the render tolerance."""
    root = eval_runs[0]
    images = {}
    for side in ("jax", "port"):
        final = np.asarray(Image.open(root / f"{side}_eval" / "validation" / "step_4_0.png"))
        rendered = np.asarray(Image.open(root / f"{side}_render" / "validation" / "step_4_0.png"))
        assert final.shape == (16, 16, 3)  # the tiny preset renders at a quarter size
        np.testing.assert_array_equal(rendered, final, err_msg=side)
        images[side] = rendered.astype(np.int32)
    # f32 both sides; adapters within 1e-5; uint8 truncation can flip a pixel by one level
    diff = np.abs(images["port"] - images["jax"])
    assert diff.max() <= 1 and diff.mean() < 0.05
