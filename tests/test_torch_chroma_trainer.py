"""The torch port's Chroma trainer against the JAX ``Trainer``, on the CPU.

Both trainers run tiny Chroma from the JAX exporter's diffusers file of one
seeded tree, warm-started from one seeded adapter, on one text cache (T5
embeds with 5 of 16 tokens valid, zero pooled embeds) with
``flux_attention_masked_training``, so every step masks the T5 padding, and
the same noise and sigmas (the Flux trainer test's recipe, cut to 2 steps).
Every tolerance is stated where it is checked.
"""

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.weight_export import export_chroma_to_diffusers

from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
from simpletuner_tpu_torch.training.lora import save_lora_safetensors

from test_torch_chroma import GRAD_REL, _jax_params, _pair
from torch_parity import rel


def _seeded_adapters(model, seed, scale=1.0):
    module = tl.init_parameters(model.create_module(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for param in tl.lora_parameters(module).values():
            param.copy_(torch.from_numpy(scale * rng.standard_normal(tuple(param.shape)).astype(np.float32)))
    return module


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _overriding, _values, _write_images

    root = tmp_path_factory.mktemp("chroma_trainer")
    _write_images(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    values = lambda out, **extra: _values(root, out, model_family="chroma", flux_attention_masked_training=True, max_train_steps=2,  # noqa: E731
                                          **extra)
    jmodel, port_model = _pair(values("x"))
    path = str(root / "chroma.safetensors")
    exported = export_chroma_to_diffusers(_jax_params(jmodel, 3), jmodel.arch)
    np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
    # the captions' payloads, cached before either run (the tiny tokenizer's
    # salted hash would give every process other embeds)
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "chroma")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"photo {i}", {"t5_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                  "pooled_embeds": np.zeros(768, np.float32),
                                  "attention_mask": (np.arange(16) < 5).astype(np.int32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(values("jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=values("port", **extra), device="cpu")
        port_trainer.run()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer


def test_trainer_matches_jax(trainer_runs):
    """2 steps, no state shared between the runs: per-step loss within 1e-5
    relative (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; the LoRA
    export holds the JAX map's names and, within ``GRAD_REL`` in relative L2,
    its tensors."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-2/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any("single_transformer_blocks.1.attn.to_q.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL


def test_trainer_builds_the_family_and_masks_the_t5_padding(trainer_runs):
    """The port's trainer built the Chroma family and the tiny VAE (as the
    JAX trainer did); its batches carry the T5 mask and zero pooled embeds,
    which become segment ids with the 11 pads at -1."""
    _, jax_trainer, port_trainer = trainer_runs
    assert port_trainer.model.NAME == jax_trainer.model.NAME == "chroma"
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4
    batch = {k: torch.from_numpy(v) for k, v in port_trainer._example_batch().items()}
    assert int(batch["t5_masks"].sum()) == 5 and not batch["pooled_embeds"].any()
    inputs = port_trainer.model.get_model_inputs(port_trainer.model.prepare_batch(torch.Generator(), batch))
    assert int((inputs["segment_ids"] == -1).sum()) == 11


def test_checkpoint_inference_renders_a_png(trainer_runs):
    """``run_inference`` (what ``simpletuner-tpu-torch inference --checkpoint``
    runs) from the port's checkpoint-2 on the CPU: the tiny text encoder
    encodes the prompt, 2 true-CFG flow Euler steps (no guidance embedding),
    one finite PNG."""
    import json
    import os

    from PIL import Image

    from simpletuner_tpu_torch.inference import run_inference

    from test_torch_trainer import _values

    root, _, _ = trainer_runs
    config = root / "render.json"
    config.write_text(json.dumps(_values(root, "port", model_family="chroma", flux_attention_masked_training=True,
                                         pretrained_model_name_or_path=str(root / "chroma.safetensors"),
                                         validation_resolution=32, validation_guidance=2.0)))
    output = str(root / "render")
    assert run_inference("a lighthouse at dusk", checkpoint=str(root / "port" / "checkpoint-2"),
                         config_path=str(config), output=output, steps=2, device="cpu") == 0
    (path,) = [os.path.join(output, "validation", f) for f in os.listdir(os.path.join(output, "validation"))]
    image = np.asarray(Image.open(path))
    assert path.endswith(".png") and image.ndim == 3 and image.shape[-1] == 3 and image.std() > 0
